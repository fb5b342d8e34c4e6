"""Seeded parameters, made on the device by the benchmark and handed alike to
the program and to the reference.

A model's random leaves are slices of one virtual stream of standard normals
truncated to [-2, 2], drawn in chunks of ``CHUNK`` elements by a
``torch.Generator`` on the device seeded from (seed, chunk index): a few
large calls, and any chunk can be drawn again alone. A leaf's ``init`` (from
the family's ``param_specs``) says what it is made of:

``("normal", s)``  s times its slice of the stream
``("dt_bias",)``    the inverse softplus of dt = 1e-3 + u (0.1 - 1e-3), u the
                    normal CDF of its slice (Mamba's dt initialisation)
``("ones",)``, ``("zeros",)``, ``("a_log",)``  constants (A_log = log n, n = 1..N)

A random leaf whose ``init`` ends in a stream number s > 0, as
``("normal", scale, 1)``, draws from stream s, a virtual stream of its own
(chunks seeded from (seed, s * STREAM_CHUNKS + chunk index)), so that adding
such a leaf leaves every other leaf's draw as it was, bit for bit. (Adding
it to stream 0 would not: a chunk's draw depends on its length.)
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

CHUNK = 1 << 26
RANDOM = ("normal", "dt_bias")
STREAM_CHUNKS = 1 << 32


def chunk_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index) % (1 << 63)


class Weights:
    """The parameters of ``specs`` for ``seed`` on ``device`` (float32)."""

    def __init__(self, specs, seed: int, device, chunk: int = CHUNK):
        self.specs, self.seed, self.device, self.chunk = list(specs), int(seed), device, chunk
        self._offsets: Dict[str, Tuple[int, int]] = {}  # name -> (stream, offset)
        self.numel: Dict[int, int] = {}  # stream -> elements
        for name, shape, init in self.specs:
            if init[0] in RANDOM:
                stream = init[2] if len(init) > 2 else 0
                self._offsets[name] = (stream, self.numel.get(stream, 0))
                self.numel[stream] = self.numel.get(stream, 0) + math.prod(shape)
        self._cached: Tuple[tuple, torch.Tensor] = (None, None)

    def _draw(self, stream: int, index: int) -> torch.Tensor:
        if self._cached[0] != (stream, index):
            self._cached = (None, None)  # free the last chunk first
            g = torch.Generator(device=self.device).manual_seed(
                chunk_seed(self.seed, stream * STREAM_CHUNKS + index))
            n = min(self.chunk, self.numel[stream] - index * self.chunk)
            buf = torch.empty(n, dtype=torch.float32, device=self.device)
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=g)
            self._cached = ((stream, index), buf)
        return self._cached[1]

    def _stream(self, out: torch.Tensor, stream: int, start: int) -> None:
        """Fill the flat ``out`` with ``stream``'s elements from ``start``."""
        flat, done = out.view(-1), 0
        while done < flat.numel():
            index, at = divmod(start + done, self.chunk)
            src = self._draw(stream, index)
            n = min(flat.numel() - done, src.numel() - at)
            flat[done:done + n].copy_(src[at:at + n])
            done += n

    @torch.no_grad()
    def leaf_into(self, out: torch.Tensor, name: str, shape, init) -> torch.Tensor:
        kind = init[0]
        if kind in RANDOM:
            self._stream(out, *self._offsets[name])
            if kind == "normal":
                out.mul_(init[1])
            else:  # dt_bias
                u = 0.5 * (1 + torch.erf(out / math.sqrt(2.0)))
                dt = 1e-3 + u * (1e-1 - 1e-3)
                out.copy_(torch.log(torch.expm1(dt)))
        elif kind == "ones":
            out.fill_(1.0)
        elif kind == "zeros":
            out.zero_()
        elif kind == "a_log":
            n = shape[-1]
            out.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                             device=out.device)).expand(shape))
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        return out

    def leaves(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, new float32 tensor) of every leaf, in drawing order."""
        for name, shape, init in self.specs:
            yield name, self.leaf_into(torch.empty(shape, dtype=torch.float32,
                                                   device=self.device), name, shape, init)
        self._cached = (None, None)

    def make(self) -> Dict[str, torch.Tensor]:
        return dict(self.leaves())

    def fill(self, params: Dict[str, torch.Tensor]) -> None:
        """Write every leaf into the tensor of its name in ``params`` (a
        model's ``named_parameters``), which must hold exactly these."""
        names = {n for n, _, _ in self.specs}
        if set(params) != names:
            raise ValueError(f"parameters differ from the specs: missing "
                             f"{sorted(names - set(params))[:5]}, extra "
                             f"{sorted(set(params) - names)[:5]}")
        for name, shape, init in self.specs:
            p = params[name]
            if tuple(p.shape) != tuple(shape):
                raise ValueError(f"{name}: the program's shape {tuple(p.shape)}, the "
                                 f"configuration's {tuple(shape)}")
            self.leaf_into(p.data, name, shape, init)
        self._cached = (None, None)

