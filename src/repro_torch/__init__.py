"""PyTorch/CUDA port of the DFedSGPSM reproduction (``repro``).

Same subpackage layout as ``repro``: each module sits at the relative path
of the reference module it answers to.  The port imports ``torch`` and
numpy only — never ``jax`` and never ``repro`` — and its kernels are CUDA
C++ for Hopper (``kernels/csrc``), built at first use.  Entry points take
an explicit ``device`` (default ``"cuda"``); the CPU runs only when a
caller asks for it, through each kernel's plain PyTorch version.
"""
