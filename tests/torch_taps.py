"""Record the positions of the port's bilinear taps
(`core/textures.sample_bilinear`: the albedo's and the sky's) in one
render and replay them in another, the witness of the bilinear gradients'
comparisons across devices or packages.

The tap's value is continuous in its position, but its texel pair, and so
its uv derivative (a texel difference times the texture width), jumps at
a texel edge, and a texel weight (1 - tx) near 0 takes the rounding of u
times the width.  Two renders whose uv differ by rounding then differ in
the texel and vertex gradients of the taps near an edge.  Replaying one
render's tap positions in the other (the value of the recorded u, v, the
gradient of the render's own) removes exactly that difference: what is
left must hold at the tight tolerance.  Imports no JAX: the card tests
use it too."""

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.core import textures as tex_mod


def texel_coords(u, v, w, h):
    """(fx, fy) of the taps in texels, as `sample_bilinear` computes them."""
    u, v = np.asarray(u, np.float32), np.asarray(v, np.float32)
    w, h = np.asarray(w, np.float32), np.asarray(h, np.float32)
    return (np.clip(u, 0.0, 1.0) * w - np.float32(0.5),
            (np.float32(1.0) - np.clip(v, 0.0, 1.0)) * h - np.float32(0.5))


class Taps:
    """The taps of one render: per call of the tap, (u, v, w, h) as numpy
    arrays (w, h broadcast to u's shape)."""

    def __init__(self):
        self.calls = []

    def add(self, u, v, w, h):
        u, v = np.asarray(u, np.float32).copy(), np.asarray(v, np.float32).copy()
        self.calls.append((u, v, np.broadcast_to(np.asarray(w), u.shape).copy(),
                           np.broadcast_to(np.asarray(h), u.shape).copy()))

    def record_port(self, mp):
        """Record the port's taps while `mp` (a pytest MonkeyPatch) holds."""
        tap = tex_mod.sample_bilinear

        def recording(texels, off, w, h, u, v):
            self.add(*(x.detach().cpu().numpy() for x in (u, v, torch.as_tensor(w),
                                                          torch.as_tensor(h))))
            return tap(texels, off, w, h, u, v)

        mp.setattr(tex_mod, "sample_bilinear", recording)

    def replay_port(self, mp, stats: dict, max_shift: float = 0.05):
        """Replay the recorded positions in the port's taps, call by call,
        while `mp` holds: u' = u + (u_recorded - u).detach() (a recorded
        call may be longer: the JAX package's child buffers are padded
        after their live lanes).  Only rounding is replayed: a tap that
        moves by `max_shift` texels or more (a ray whose hit differs, in a
        pixel left out of the loss) keeps its own position.  `stats`
        gathers the taps, the taps whose texel pair the replay changed
        (`flipped`), the taps left as they were (`kept`) and the largest
        shift replayed in texels (`shift`)."""
        tap = tex_mod.sample_bilinear
        stats.update(calls=0, taps=0, flipped=0, kept=0, shift=0.0)

        def replaying(texels, off, w, h, u, v):
            i = stats["calls"]
            assert i < len(self.calls), "more taps than were recorded"
            n = u.shape[0]
            ru, rv, _, _ = self.calls[i]
            assert n <= ru.shape[0], f"call {i}: {n} taps, {ru.shape[0]} recorded"
            w_, h_ = (np.broadcast_to(torch.as_tensor(x).detach().cpu().numpy(), (n,))
                      for x in (w, h))
            fx, fy = texel_coords(u.detach().cpu().numpy(), v.detach().cpu().numpy(), w_, h_)
            gx, gy = texel_coords(ru[:n], rv[:n], w_, h_)
            shift = np.maximum(np.abs(fx - gx), np.abs(fy - gy))
            near = shift < max_shift
            flips = (np.floor(fx) != np.floor(gx)) | (np.floor(fy) != np.floor(gy))
            stats["calls"] += 1
            stats["taps"] += n
            stats["flipped"] += int((flips & near).sum())
            stats["kept"] += int((~near).sum())
            if near.any():
                stats["shift"] = max(stats["shift"], float(shift[near].max()))
            ru, rv = (torch.tensor(np.where(near, x[:n], y), device=u.device)
                      for x, y in ((ru, u.detach().cpu().numpy()), (rv, v.detach().cpu().numpy())))
            return tap(texels, off, w, h, u + (ru - u).detach(), v + (rv - v).detach())

        mp.setattr(tex_mod, "sample_bilinear", replaying)
