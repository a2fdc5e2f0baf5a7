"""The benchmark's frozen counts: the FLOPs of the policy's matmuls and
convolutions (``flops.py``), the least work of the splat z-buffer kernel
(``splat.py``) and the card's peaks (``peaks.json``), so that no change
to the program moves the yardstick its shares are read against."""
