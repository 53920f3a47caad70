"""The port's native host library (``audio.cpp``, bound by ``bindings``)."""
