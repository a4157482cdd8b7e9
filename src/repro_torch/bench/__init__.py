"""The paper's figure and table benchmarks on the port (ports of
``benchmarks/common.py``, ``fig1``-``fig5``, ``table1`` and
``examples/quickstart.py``).  ``python -m repro_torch.bench.run`` runs
them; every stepsize tune is one :class:`repro_torch.methods.Sweeper`
run."""
