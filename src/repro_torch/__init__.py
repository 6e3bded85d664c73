"""PyTorch + CUDA port of the Pilot-Abstraction reproduction.

Mirrors the JAX package ``repro`` module for module
(``repro/<x>.py`` -> ``repro_torch/<x>.py``) and imports none of it.
Entry points run on CUDA devices unless the caller passes CPU devices.
"""
