import os

# Smoke tests and benches must see ONE device (the dry-run sets its own 512
# placeholder devices in its own process — never here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running integration test")
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")
