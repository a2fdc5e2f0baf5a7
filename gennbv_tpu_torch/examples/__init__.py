"""Examples of the port's API, each a module run with ``python -m``."""
