"""SpecAugment: random time and frequency masking of log-mel features
(counterpart of dcase2019_task4_tpu/ops/specaugment.py, the scaled
configuration's augmentation of the student features).

Per clip, `time_masks` contiguous time spans of width ~ U{0, …,
max_time_width} starting at ~ U{0, …, T − 1}, and `freq_masks` frequency
spans likewise, are set to `mask_value` (0: the mean of standardised
features). The draws come from the caller's `torch.Generator` on the
generator's device, in the JAX function's order (time starts, time widths,
frequency starts, frequency widths); they are [B, n] integers, and the
masks are built from them on the features' device. With the generator on
the card nothing is drawn on the host. The numbers differ from JAX's
(another generator): parity is held with injected masks (`apply_masks`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def axis_mask(generator: torch.Generator, batch: int, size: int, n_masks: int, max_width: int,
              device) -> torch.Tensor:
    """[batch, size] bool, True where one of `n_masks` spans per row covers
    the index: starts ~ U{0, …, size − 1}, widths ~ U{0, …, max_width}."""
    starts = torch.randint(0, size, (batch, n_masks), generator=generator, device=generator.device).to(device)
    widths = torch.randint(0, max_width + 1, (batch, n_masks), generator=generator, device=generator.device).to(device)
    idx = torch.arange(size, device=device)[None, None, :]
    return ((idx >= starts[..., None]) & (idx < (starts + widths)[..., None])).any(dim=1)


def draw_masks(generator: torch.Generator, shape, time_masks: int = 2, max_time_width: int = 64,
               freq_masks: int = 2, max_freq_width: int = 16,
               device=None) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(time mask [B, T] or None, frequency mask [B, F] or None) for
    features of `shape` [B, T, F], on `device`."""
    B, T, F = shape
    tm = axis_mask(generator, B, T, time_masks, max_time_width, device) if time_masks > 0 else None
    fm = axis_mask(generator, B, F, freq_masks, max_freq_width, device) if freq_masks > 0 else None
    return tm, fm


def apply_masks(x: torch.Tensor, time_mask: Optional[torch.Tensor], freq_mask: Optional[torch.Tensor],
                mask_value: float = 0.0) -> torch.Tensor:
    """x [B, T, F] with the masked frames ([B, T] bool) and bins ([B, F]
    bool) set to `mask_value`."""
    fill = torch.full((), mask_value, dtype=x.dtype, device=x.device)
    if time_mask is not None:
        x = torch.where(time_mask[:, :, None], fill, x)
    if freq_mask is not None:
        x = torch.where(freq_mask[:, None, :], fill, x)
    return x


def spec_augment(x: torch.Tensor, generator: torch.Generator, time_masks: int = 2, max_time_width: int = 64,
                 freq_masks: int = 2, max_freq_width: int = 16, mask_value: float = 0.0) -> torch.Tensor:
    """x [B, T, F] features → masked features of the same shape."""
    masks = draw_masks(generator, x.shape, time_masks, max_time_width, freq_masks, max_freq_width, x.device)
    return apply_masks(x, *masks, mask_value)
