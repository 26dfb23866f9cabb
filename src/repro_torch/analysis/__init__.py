"""repro_torch.analysis — static checks over the port's source.

``protocol`` — the ``MSG_*`` transition table of the socket transport and a
race-detector-lite for the socket server's shared state.
"""
