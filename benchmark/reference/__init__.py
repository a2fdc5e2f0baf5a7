"""The plain reference the benchmark holds the program to: plain PyTorch
and numpy, importing nothing of the program (``gennbv_tpu_torch``) and
nothing of JAX.  It reads the configuration files and the benchmark's
own inputs, and follows the program's actions and minibatches only to
judge its outputs (``benchmark/compare.py``)."""
