"""PyTorch/CUDA port of the DASHA reproduction (the JAX package ``repro``
is the reference it is tested against).

The layout mirrors ``repro``: ``compress`` (specs, plans, backends),
``core`` (oracles, theory, stateless RNG), ``data`` (synthetic problems),
``kernels`` (hand-written CUDA kernels for Hopper and their plain torch
versions) and ``methods`` (variant rules, substrate, engine, driver).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
