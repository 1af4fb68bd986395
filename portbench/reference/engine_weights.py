"""The serving engine's weights, worked out again: the engine draws its
own bf16 parameters from a ``torch.Generator`` on its device seeded 0,
whatever the run's seed, one normal draw per parameter in this order,
each scaled and rounded to bf16. A frozen copy of that table; nothing
is read from the engine."""

from __future__ import annotations

from typing import Dict

import torch

ENGINE_SEED = 0


def engine_params(d: int, f: int, v: int, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    table = (("embed", (v, d), 0.02), ("wq", (d, d), d ** -0.5),
             ("wk", (d, d), d ** -0.5), ("wv", (d, d), d ** -0.5),
             ("wo", (d, d), d ** -0.5), ("w1", (d, f), d ** -0.5),
             ("w2", (f, d), f ** -0.5), ("out", (d, v), d ** -0.5))
    gen = torch.Generator(device=device).manual_seed(ENGINE_SEED)
    return {name: (torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32) * scale).to(torch.bfloat16)
            for name, shape, scale in table}
