"""repro_torch.launch — command-line entry points of the port
(``solver_serve``: the serving engine on a synthetic request stream;
``serve``: the LM serving driver, prefill then decode), the LM prefill /
decode steps (``steps``) and the device mesh (``mesh``)."""
