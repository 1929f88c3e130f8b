"""The paper's planted design (Bakas 2021, Table 1): x ~ N(0, 1) of
(obs, vars), fp32, in one draw.  The default of a configuration that names
no design."""
import torch


def draw(config: dict, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn((int(config["obs"]), int(config["vars"])),
                       generator=generator, device=device,
                       dtype=torch.float32)
