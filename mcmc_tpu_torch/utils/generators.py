"""The run's generator and its children, and the positions' dtype: what the
benchmark runner and the tune-and-sample CLI share where the JAX package
splits a PRNG key and enables x64."""

import torch


def make_generator(seed: int, device) -> torch.Generator:
    """The run's generator on `device`, seeded from `seed`."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A child generator on the same device, seeded by one draw of the
    parent (the JAX package's random.split)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return make_generator(seed, generator.device)


def position_dtype(device) -> torch.dtype:
    """float32 on a card (the fused kernels'), float64 elsewhere."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
