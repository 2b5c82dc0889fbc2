"""Entry-point drivers of the port (counterpart of ``repro.launch`` and
the reference's ``examples/``): ``python -m repro_torch.launch.train_rsl``
runs the paper's RSL application, ``python -m
repro_torch.launch.solve_serve`` replays synthetic traffic through the
solve server."""
