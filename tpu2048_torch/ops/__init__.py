"""Table ops and the hand-written CUDA kernels (``tpu2048/ops``).

``kernels.py`` wraps the kernels built from ``csrc/`` by ``build.py``;
``dispatch.py`` builds evaluators on top of them.  Nothing here builds
or loads a kernel at import time.
"""
