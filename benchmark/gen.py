"""The one traffic generator: a synthetic video clip made from a seed.

Every traffic mix is a file of parameters under ``traffic/``; this module
reads them.  A clip is ``frames`` grayscale uint8 frames of the
configuration's size, made on the given device from ``torch.Generator``:

  * a multi-octave value-noise background larger than the frame, panned by
    one integer velocity in [-pan_px, pan_px]^2 a frame (the camera);
  * ``objects`` (a range) textured rectangles, each of a size in
    ``object_px``, each moving by its own integer velocity in
    [-object_motion_px, object_motion_px]^2 a frame and wrapping around the
    frame, later ones over earlier ones: their edges occlude the
    background and each other;
  * Gaussian sensor noise of ``noise_sigma`` grey levels on every frame.

The same seed on the same device gives the same clip.  Every seed gives
the same frame size and count, so the work a run does does not depend on
the seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _randint(g: torch.Generator, lo: int, hi: int, n: int, device) -> list[int]:
    """n integers uniform in [lo, hi]."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device).tolist()


def texture(h: int, w: int, octaves: int, coarsest_px: int, g: torch.Generator,
            device) -> torch.Tensor:
    """(h, w) float32 multi-octave value noise scaled to [0, 255]: octave o
    is Gaussian noise on a grid of coarsest_px / 2^o pixels, upsampled
    bilinearly, at amplitude 0.6^o."""
    img = torch.zeros((h, w), dtype=torch.float32, device=device)
    for o in range(octaves):
        step = max(1, coarsest_px >> o)
        gh, gw = h // step + 2, w // step + 2
        grid = torch.randn((1, 1, gh, gw), generator=g, device=device)
        up = F.interpolate(grid, size=(gh * step, gw * step), mode="bilinear",
                           align_corners=False)
        img += (0.6 ** o) * up[0, 0, :h, :w]
    img -= img.min()
    return img * (255.0 / img.max().clamp_min(1e-6))


def clip(traffic: dict, height: int, width: int, frames: int, seed: int,
         device) -> torch.Tensor:
    """(frames, height, width) uint8 frames of one seeded clip."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pan = int(traffic["pan_px"])
    margin = pan * (frames - 1)
    bg = texture(height + 2 * margin, width + 2 * margin, traffic["octaves"],
                 traffic["background_grain_px"], g, device)
    vy, vx = _randint(g, -pan, pan, 2, device)
    lo, hi = traffic["objects"]
    objects = []
    for _ in range(_randint(g, lo, hi, 1, device)[0]):
        oh, ow = _randint(g, *traffic["object_px"], 2, device)
        y0 = _randint(g, -oh // 2, height - oh // 2, 1, device)[0]
        x0 = _randint(g, -ow // 2, width - ow // 2, 1, device)[0]
        m = int(traffic["object_motion_px"])
        ovy, ovx = _randint(g, -m, m, 2, device)
        tex = texture(oh, ow, traffic["octaves"], traffic["object_grain_px"], g, device)
        objects.append((tex, y0, x0, ovy, ovx))
    out = torch.empty((frames, height, width), dtype=torch.float32, device=device)
    for t in range(frames):
        ys, xs = margin + vy * t, margin + vx * t
        out[t] = bg[ys:ys + height, xs:xs + width]
        for tex, y0, x0, ovy, ovx in objects:
            oh, ow = tex.shape
            # positions wrap so that every object stays in view
            y = (y0 + ovy * t + oh) % (height + oh) - oh
            x = (x0 + ovx * t + ow) % (width + ow) - ow
            fy0, fy1 = max(y, 0), min(y + oh, height)
            fx0, fx1 = max(x, 0), min(x + ow, width)
            if fy0 < fy1 and fx0 < fx1:
                out[t, fy0:fy1, fx0:fx1] = tex[fy0 - y:fy1 - y, fx0 - x:fx1 - x]
    out += float(traffic["noise_sigma"]) * torch.randn(out.shape, generator=g, device=device)
    return out.round_().clamp_(0, 255).to(torch.uint8)


def pool(traffic: dict, height: int, width: int, seed: int, device) -> torch.Tensor:
    """The frames of the run's request pool: ``pool_requests`` requests of
    ``batch`` consecutive pairs each, request k on frames k*batch ..
    (k+1)*batch: (pool_requests * batch + 1, height, width) uint8."""
    n = int(traffic["pool_requests"]) * int(traffic["batch"]) + 1
    return clip(traffic, height, width, n, seed, device)
