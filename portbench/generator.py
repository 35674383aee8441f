"""Load profiles made on the device from a seed.

The statistics of ``dctpu_torch/corpus/synth.py`` (its ``synth_stream``),
with every number a parameter of the configuration's ``signal``:
instantaneous watts = mean * (1 + 0.5 * (daily, half-daily and weekly
sines with random phases)) + appliances switching on and off + Gaussian
noise, floored at 0 and rounded; a share of the meters report a
cumulative register instead (Wh, the running sum of the watts).

Made in a few large torch calls on the device, from one
``torch.Generator`` seeded with the run's seed. Each meter's scalar
parameters (mean load, appliance powers and toggle rates) are drawn
stratified: meter i of S gets a value from stratum perm[i] of S equal
strata of the range, so every seed covers the range alike and only the
order and the fine detail differ; exactly round(cumulative_frac * S)
meters are registers.
"""

from __future__ import annotations

import math

import torch

DAY_S = 86400.0


def _stratified(g, S, lo, hi, device):
    """[S, 1] float64 values in [lo, hi): one from each of S strata, in a
    random order."""
    u = torch.rand(S, device=device, generator=g, dtype=torch.float64)
    perm = torch.randperm(S, device=device, generator=g).to(torch.float64)
    return (lo + (hi - lo) * (perm + u) / S)[:, None]


def load_profiles(signal: dict, num_streams: int, samples: int, cadence_s: int,
                  seed: int, device) -> torch.Tensor:
    """[num_streams, samples] int32 load profiles on ``device``."""
    S, n = num_streams, samples
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(device=device, dtype=torch.float64)
    t = torch.arange(n, **f64) * (cadence_s * 2 * math.pi / DAY_S)
    ph = torch.rand(S, 3, generator=g, **f64) * (2 * math.pi)
    shape = (0.6 * torch.sin(t + ph[:, :1])
             + 0.25 * torch.sin(2 * t + ph[:, 1:2])
             + 0.15 * torch.sin(t / 7 + ph[:, 2:3]))
    mean = _stratified(g, S, *signal["mean_w"], device)
    watts = mean * (1.0 + 0.5 * shape)
    del shape
    for _ in range(signal["appliances"]):
        power = _stratified(g, S, *signal["appliance_w"], device)
        rate = _stratified(g, S, *signal["toggle_rate"], device)
        toggles = torch.rand(S, n, generator=g, device=device, dtype=torch.float32) < rate
        watts += power * (torch.cumsum(toggles, 1, dtype=torch.int32) & 1)
        del toggles
    watts += torch.randn(S, n, generator=g, **f64) * (mean * signal["noise_frac"])
    watts.clamp_(min=0.0)
    registers = round(signal["cumulative_frac"] * S)
    if registers:
        idx = torch.randperm(S, generator=g, device=device)[:registers]
        wh = torch.cumsum(watts[idx] * (cadence_s / 3600.0), 1)
        watts[idx] = wh.clamp_(max=2**31 - 1).floor_()
    return torch.round(watts).to(torch.int32)
