"""Counterparts of the JAX package's ``examples/``, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.calibrate_and_serve [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.gateway_smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.flight_smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_then_sparsify [--device cpu]

Each runs on the card unless given ``--device cpu``.
"""
