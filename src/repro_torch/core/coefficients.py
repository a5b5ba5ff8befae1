"""Newton-Schulz iteration coefficient sets.

Two families, selectable per config (paper §4 "Configurations"):

* ``polar_express`` — the per-iteration optimal quintic coefficients of
  Amsel et al., "The Polar Express" (arXiv:2505.16932).  DMuon adopts these
  as the default for k = 5 NS steps.
* ``quintic`` — the standard fixed (a, b, c) quintic of the original Muon
  implementation (Jordan et al., 2024), identical at every iteration.

Each entry is an ``(a, b, c)`` triple applied as ``p(X) = aX + bX³ + cX⁵``
in the matrix sense, equivalently ``X' = (aI + bG + cG²) X`` with the Gram
matrix ``G = XXᵀ``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

Coeffs = Tuple[float, float, float]

# Per-iteration Polar Express schedule (safety-factored), from the reference
# implementation accompanying arXiv:2505.16932.  Longer runs repeat the final
# (converged) triple, which is the fixed point of the optimal schedule.
POLAR_EXPRESS: Tuple[Coeffs, ...] = (
    (8.28721201814563, -23.595886519098837, 17.300387312530933),
    (4.107059111542203, -2.9478499167379106, 0.5448431082926601),
    (3.9486908534822946, -2.908902115962949, 0.5518191394370137),
    (3.3184196573706015, -2.488488024314874, 0.51004894012372),
    (2.300652019954817, -1.6689039845747493, 0.4188073119525673),
    (1.891301407787398, -1.2679958271945868, 0.37680408948524835),
    (1.8750014808534479, -1.2500016453999487, 0.3750001645474248),
    (1.875, -1.25, 0.375),
)

# Original Muon quintic, used for every iteration.
QUINTIC: Coeffs = (3.4445, -4.7750, 2.0315)


def get_coefficients(name: str, num_steps: int) -> Tuple[Coeffs, ...]:
    """Return the per-iteration ``(a, b, c)`` schedule for ``num_steps`` steps."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if name == "polar_express":
        sched = list(POLAR_EXPRESS[:num_steps])
        while len(sched) < num_steps:  # repeat the converged triple
            sched.append(POLAR_EXPRESS[-1])
        return tuple(sched)
    if name == "quintic":
        return tuple(QUINTIC for _ in range(num_steps))
    raise ValueError(f"unknown coefficient schedule {name!r} "
                     "(expected 'polar_express' or 'quintic')")


def validate_schedule(schedule: Sequence[Coeffs]) -> None:
    """Sanity-check a user-provided schedule."""
    for i, abc in enumerate(schedule):
        if len(abc) != 3:
            raise ValueError(f"schedule[{i}] must be an (a, b, c) triple, got {abc!r}")
