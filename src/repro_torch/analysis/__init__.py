"""repro_torch.analysis — static checks over the port and its rounds.

``lint``      — the four repo-specific AST rules over ``src/repro_torch/``.
``contracts`` — the five round contracts, checked against recorded eager
                rounds (``RoundRecorder``), and ``run_contracts``.
``ir``        — the round matrix at tiny shapes: every constructible
                configuration recorded, mesh-free in process and sharded on
                four gloo ranks.
``protocol``  — the ``MSG_*`` transition table of the socket transport and a
                race-detector-lite for the socket server's shared state.

``scripts/check_static_torch.py`` runs all of them (and ruff, where it is
installed) and exits 1 on any violation.
"""
