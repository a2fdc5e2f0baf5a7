"""The traffic loops: each ``<loop>.py`` holds a ``Loop`` that builds
the program on a cell's configuration, warms it up, runs the timed window
(and the traced one), and judges what it produced with the reference."""
