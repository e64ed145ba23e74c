"""A source of the tests: bytes below ``alphabet``, uniform, from the seed."""

import torch


def make_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    shape = (traffic["pool_units"], config["unit_bytes"])
    return torch.randint(0, traffic["alphabet"], shape, generator=gen).to(torch.uint8).to(device)
