"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
(:mod:`.dasha_update`), the plain torch versions (:mod:`.ref`) and the
CPU/CUDA dispatch (:mod:`.ops`)."""
