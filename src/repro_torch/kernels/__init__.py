"""Hand-written Hopper kernels for the framework's compute hot-spots.

Each kernel ships as:
  <name>/csrc/*.cu — the CUDA C++ source (sm_90a), with a plain C entry
  <name>/<name>.py — builds the source with nvcc and binds it via ctypes
  <name>/ops.py    — public wrapper: checks, output allocation, launch
                     counter; the plain version for CPU tensors
  <name>/ref.py    — the plain PyTorch version, the kernel's oracle

Kernels are compiled on first use (never at import) into ``build/kernels/``
at the repository root; see :mod:`repro_torch.kernels.build`.
"""
