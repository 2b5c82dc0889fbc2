"""Entry-point drivers of the port (counterpart of ``repro.launch`` and
the reference's ``examples/``): ``python -m repro_torch.launch.train_rsl``
runs the paper's RSL application, ``launch.solve_serve`` replays
synthetic traffic through the solve server, ``launch.train`` and
``launch.serve`` train and serve an LM, ``launch.train_lm`` trains one
data-parallel with Krylov gradient compression over gloo ranks,
``launch.serve_lm`` decodes one, and ``launch.quickstart`` tours the
solver facade.  ``launch.mesh`` builds meshes and local worlds;
``launch.input_specs`` the dry-run's abstract inputs."""
