"""A design module for the harness's tests, found through
``spec.DESIGN_DIR``: features whose columns share one direction, as a
language model's activations do.

``x = t @ (I + mix * w / sqrt(vars)) + shared * u``: tokens ``t`` (obs,
vars) and weights ``w`` (vars, vars) drawn from the generator, then one
direction ``u`` (obs, 1) that every column carries at the configuration's
``shared`` scale.  That common direction makes the Gram matrix's largest
eigenvalue grow with vars, so Algorithm 2's block update at omega 1
overshoots and a traffic has to state a smaller omega.  ``draw`` computes
the features in fp32 (TF32 off) as a program's forward would; ``check``
draws the same tokens and weights again from each design's generator
state and reads ``feature_err``, the worst relative gap to an fp64
forward.
"""
import torch

CHECKS = ("feature_err",)


def _parts(config, generator, device):
    obs, nvars = int(config["obs"]), int(config["vars"])
    t = torch.randn((obs, nvars), generator=generator, device=device,
                    dtype=torch.float32)
    w = torch.randn((nvars, nvars), generator=generator, device=device,
                    dtype=torch.float32)
    w *= float(config["mix"]) / nvars ** 0.5
    w += torch.eye(nvars, device=device)
    u = torch.randn((obs, 1), generator=generator, device=device,
                    dtype=torch.float32)
    return t, w, u


def draw(config, generator, device):
    t, w, u = _parts(config, generator, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return t @ w + float(config["shared"]) * u
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def check(config, designs, device):
    worst = 0.0
    for d in designs:
        g = torch.Generator(device=device)
        g.set_state(d.state)
        t, w, u = (p.double() for p in _parts(config, g, device))
        ref = t @ w + float(config["shared"]) * u
        worst = max(worst, float((d.x.double() - ref).abs().max()
                                 / ref.abs().max()))
    return {"feature_err": worst}
