"""Fourier-domain enhancement.

The luminance of a low-light image lives mostly in the FFT amplitude
spectrum, its structure in the phase; scaling the amplitude brightens
without disturbing edges. The FFTs are ``torch.fft`` (cuFFT on the card),
as the JAX package's are XLA's FFT.
"""

from __future__ import annotations

import torch


def _polar(amp: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """amp * exp(1j * phase) as a complex64 tensor."""
    return amp * torch.exp(torch.complex(torch.zeros_like(phase), phase))


def fourier_amplitude_boost(x: torch.Tensor, factor: float = 1.5,
                            preserve_dc: bool = False) -> torch.Tensor:
    """Scale the FFT amplitude spectrum of the last two axes by ``factor``,
    keeping the phase; clipped back to [0, 1].

    ``preserve_dc=True`` keeps the DC term (the mean brightness) and scales
    only the AC amplitudes: a contrast boost instead of a brightness boost.
    """
    spec = torch.fft.rfft2(x)
    amp = torch.abs(spec)
    phase = torch.angle(spec)
    new_amp = amp * factor
    if preserve_dc:
        new_amp[..., :1, :1] = amp[..., :1, :1]
    out = torch.fft.irfft2(_polar(new_amp, phase), s=x.shape[-2:])
    return torch.clamp(out, 0.0, 1.0)


def amplitude_phase_swap(content: torch.Tensor,
                         style: torch.Tensor) -> torch.Tensor:
    """``content``'s phase (structure) recombined with ``style``'s amplitude
    (illumination and colour statistics)."""
    c_spec = torch.fft.rfft2(content)
    s_spec = torch.fft.rfft2(style)
    out = torch.fft.irfft2(_polar(torch.abs(s_spec), torch.angle(c_spec)),
                           s=content.shape[-2:])
    return torch.clamp(out, 0.0, 1.0)
