"""Measurement helpers: analytic FLOP counts and tracing."""
