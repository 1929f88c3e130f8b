"""repro_torch.launch — command-line entry points of the port
(``solver_serve``: the serving engine on a synthetic request stream)."""
