"""The port's bridge to the repository's C++ CPU backend (``native/``)."""
