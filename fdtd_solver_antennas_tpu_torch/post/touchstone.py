"""Touchstone (.sNp) S-parameter export/import (beyond-reference).

A copy of ``fdtd_solver_antennas_tpu/post/touchstone.py`` (NumPy only).

The reference keeps its S11 sweeps inside plotted figures and never
writes machine-readable RF data, so its results cannot feed ADS/AWR/
scikit-rf/QUCS downstream. This module writes Touchstone version 1
files — the lingua franca of RF tooling — from any solver result:

- 1-port: the S11 sweep every FDTD solver returns
  (``result.freq``/``result.s11``),
- N-port: a full S matrix ``(N, N, Nf)`` with per-port ``z_ref``.

Touchstone v1 supports a single real reference resistance (the ``R``
token on the option line). When ports carry different references, the
matrix is renormalized exactly (via the Z-matrix, real references —
Pozar, *Microwave Engineering*, §4.3) before writing, and the original
per-port references are preserved in a comment for lossless round-trip
by tools that read them.

Format notes (Touchstone spec v1.1):

- option line ``# HZ S RI R <r>`` (frequency unit, parameter, format,
  reference resistance); comments start with ``!``;
- 1-/2-port: one line per frequency; the 2-port column order is
  ``S11 S21 S12 S22`` (column-major — a spec quirk unique to N=2);
- N ≥ 3: row-major, each matrix row starts a new line, at most four
  complex pairs per line.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np

_UNIT_HZ = {"HZ": 1.0, "KHZ": 1e3, "MHZ": 1e6, "GHZ": 1e9}


def renormalize_s(
    s: np.ndarray,
    z_old: Union[float, Sequence[float]],
    z_new: Union[float, Sequence[float]],
) -> np.ndarray:
    """Exactly renormalize an S matrix between real reference impedances.

    ``s`` is ``(N, N, Nf)`` (or anything broadcastable to it with the
    port axes first). Route: S(z_old) → Z → S(z_new), with the real-
    reference wave definitions ``a_i = (V_i + z_i I_i) / (2 sqrt(z_i))``
    — the convention of the engine's port spectra, so a renormalized
    matrix stays consistent with the engine's port DFTs.

        G = D_old^{-1} S D_old            (D_old = diag(1/sqrt(z_old)))
        Z = (I - G)^{-1} (I + G) Z_old
        S' = D_new (Z - Z_new)(Z + Z_new)^{-1} D_new^{-1}
    """
    s = np.asarray(s, dtype=complex)
    n = s.shape[0]
    z_old = np.broadcast_to(np.asarray(z_old, dtype=float), (n,))
    z_new = np.broadcast_to(np.asarray(z_new, dtype=float), (n,))
    if np.allclose(z_old, z_new):
        return s.copy()
    if np.any(z_old <= 0) or np.any(z_new <= 0):
        raise ValueError("reference impedances must be positive and real")

    # (Nf, N, N) for batched linalg
    sf = np.moveaxis(s.reshape(n, n, -1), -1, 0)
    eye = np.eye(n)
    r_old = np.sqrt(z_old)
    g = sf * (r_old[:, None] / r_old[None, :])  # D^{-1} S D, elementwise
    z = np.linalg.solve(eye - g, (eye + g) * z_old[None, None, :])
    r_new = np.sqrt(z_new)
    num = (z - np.diag(z_new)) / (r_new[:, None] * r_new[None, :])
    den = (z + np.diag(z_new)) / (r_new[:, None] * r_new[None, :])
    # S' = D (Z-Z2) D · [D (Z+Z2) D]^{-1} with D = diag(1/sqrt(z_new)):
    # the two scalings compose to the similarity transform above.
    s2 = np.linalg.solve(np.swapaxes(den, -1, -2), np.swapaxes(num, -1, -2))
    s2 = np.swapaxes(s2, -1, -2)
    return np.moveaxis(s2, 0, -1).reshape(s.shape)


def _as_matrix(s: np.ndarray) -> np.ndarray:
    """Accept (Nf,) one-port vectors or (N, N, Nf) matrices."""
    s = np.asarray(s, dtype=complex)
    if s.ndim == 1:
        return s.reshape(1, 1, -1)
    if s.ndim == 3 and s.shape[0] == s.shape[1]:
        return s
    raise ValueError(f"expected (Nf,) or (N, N, Nf) S data, got {s.shape}")


def format_touchstone(
    freq_hz: np.ndarray,
    s: np.ndarray,
    z_ref: Union[float, Sequence[float]] = 50.0,
    comments: Sequence[str] = (),
    freq_unit: str = "HZ",
) -> Tuple[str, int]:
    """Format Touchstone v1 text in memory → ``(text, n_ports)``.

    ``s`` is ``(Nf,)`` (one-port) or ``(N, N, Nf)``; ``z_ref`` a scalar
    or per-port vector. Non-uniform references are renormalized to their
    first port's value (exactly; see :func:`renormalize_s`) and the
    originals recorded in a ``! Port reference impedances:`` comment.
    :func:`write_touchstone` is the file-path wrapper.
    """
    s = _as_matrix(s)
    n = s.shape[0]
    freq_hz = np.asarray(freq_hz, dtype=float).ravel()
    if freq_hz.shape[0] != s.shape[2]:
        raise ValueError(
            f"{freq_hz.shape[0]} frequencies but {s.shape[2]} S samples"
        )
    unit = freq_unit.upper()
    if unit not in _UNIT_HZ:
        raise ValueError(f"freq_unit must be one of {sorted(_UNIT_HZ)}")
    z_ref = np.broadcast_to(np.asarray(z_ref, dtype=float), (n,)).copy()

    # Drop non-finite frequency points instead of writing literal 'nan'
    # tokens (which ADS/scikit-rf/QUCS reject). port_spectra sets S11 to
    # NaN at frequencies with no incident energy, so these are expected
    # inputs.
    finite = np.isfinite(s).all(axis=(0, 1))
    n_dropped = int((~finite).sum())
    if n_dropped == s.shape[2]:
        raise ValueError(
            "all frequency points contain non-finite S values; nothing "
            "to write (check the excitation/incident-energy floor)"
        )
    if n_dropped:
        s = s[:, :, finite]
        freq_hz = freq_hz[finite]

    lines = [
        f"! {n}-port S-parameters — fdtd_solver_antennas_tpu_torch "
        f"({datetime.date.today().isoformat()})",
    ]
    lines += [f"! {c}" for c in comments]
    if n_dropped:
        lines.append(
            f"! {n_dropped} frequency point(s) with non-finite S values "
            "omitted (no incident energy at those frequencies)"
        )
    r_write = float(z_ref[0])
    if not np.allclose(z_ref, r_write):
        lines.append(
            "! Port reference impedances before renormalization to "
            f"R={r_write:g}: {', '.join(f'{z:g}' for z in z_ref)} ohm"
        )
        s = renormalize_s(s, z_ref, r_write)
    lines.append(f"# {unit} S RI R {r_write:g}")

    fs = freq_hz / _UNIT_HZ[unit]
    for k, f in enumerate(fs):
        if n == 1:
            lines.append(
                f"{f:.9g} {s[0, 0, k].real:.9g} {s[0, 0, k].imag:.9g}"
            )
        elif n == 2:
            vals = [s[0, 0, k], s[1, 0, k], s[0, 1, k], s[1, 1, k]]
            lines.append(
                f"{f:.9g} "
                + " ".join(f"{v.real:.9g} {v.imag:.9g}" for v in vals)
            )
        else:
            for i in range(n):
                row = s[i, :, k]
                for j0 in range(0, n, 4):
                    seg = " ".join(
                        f"{v.real:.9g} {v.imag:.9g}" for v in row[j0:j0 + 4]
                    )
                    prefix = f"{f:.9g} " if (i == 0 and j0 == 0) else "  "
                    lines.append(prefix + seg)
    return "\n".join(lines) + "\n", n


def write_touchstone(
    path: Union[str, Path],
    freq_hz: np.ndarray,
    s: np.ndarray,
    z_ref: Union[float, Sequence[float]] = 50.0,
    comments: Sequence[str] = (),
    freq_unit: str = "HZ",
) -> Path:
    """Write a Touchstone v1 ``.sNp`` file (see :func:`format_touchstone`).

    Returns the path actually written (the suffix is forced to the
    port-count-correct ``.sNp``)."""
    text, n = format_touchstone(freq_hz, s, z_ref, comments, freq_unit)
    path = Path(path).with_suffix(f".s{n}p")
    path.write_text(text)
    return path


def read_touchstone(
    path: Union[str, Path],
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Read a Touchstone v1 file → ``(freq_hz, s(N,N,Nf), z_ref)``.

    Port count comes from the ``.sNp`` suffix; RI/MA/DB formats and all
    frequency units are handled. Used by the round-trip tests and as a
    general import utility (e.g. comparing against a VNA measurement).
    """
    import re

    path = Path(path)
    m = re.fullmatch(r"\.s(\d+)p", path.suffix.lower())
    if m is None:  # near-misses like '.sp' or '.step' get the real message
        raise ValueError(f"not a Touchstone .sNp file: {path.name}")
    n = int(m.group(1))

    unit_scale, fmt, r = 1e9, "MA", 50.0  # spec defaults: GHZ S MA R 50
    tokens: list[float] = []
    for raw in path.read_text().splitlines():
        line = raw.split("!", 1)[0].strip()
        if not line:
            continue
        if line.startswith("#"):
            opts = line[1:].upper().split()
            i = 0
            while i < len(opts):
                if opts[i] in _UNIT_HZ:
                    unit_scale = _UNIT_HZ[opts[i]]
                elif opts[i] in ("RI", "MA", "DB"):
                    fmt = opts[i]
                elif opts[i] == "R" and i + 1 < len(opts):
                    r = float(opts[i + 1])
                    i += 1
                elif opts[i] in ("S", "Y", "Z", "H", "G"):
                    # parameter-type token: only S-parameters are supported
                    # (a Z/Y/H/G file silently parsed as S would corrupt
                    # every downstream number)
                    if opts[i] != "S":
                        raise ValueError(
                            f"{path.name} declares {opts[i]}-parameters on "
                            "its option line; only S-parameter Touchstone "
                            "files are supported"
                        )
                i += 1
            continue
        tokens.extend(float(t) for t in line.split())

    per_freq = 1 + 2 * n * n
    if len(tokens) % per_freq:
        raise ValueError(
            f"token count {len(tokens)} is not a multiple of {per_freq} "
            f"for a {n}-port file"
        )
    data = np.asarray(tokens, dtype=float).reshape(-1, per_freq)
    freq_hz = data[:, 0] * unit_scale
    a, b = data[:, 1::2], data[:, 2::2]  # (Nf, N²) each
    if fmt == "RI":
        vals = a + 1j * b
    elif fmt == "MA":
        vals = a * np.exp(1j * np.deg2rad(b))
    else:  # DB
        vals = 10.0 ** (a / 20.0) * np.exp(1j * np.deg2rad(b))
    s = np.moveaxis(vals.reshape(-1, n, n), 0, -1)
    if n == 2:  # undo the 2-port column-major quirk
        s = np.swapaxes(s, 0, 1)
    return freq_hz, s, r
