"""Filter configurations: frozen, hashable dataclasses.

A copy of ``savgol_tpu.config``, kept whole so that importing the port does
not import JAX (``savgol_tpu/__init__.py`` does). Both raise the same
validation errors; ``tests/test_torch_config_weights.py`` holds them equal.

These mirror the reference C config structs and enforce the exact same
constraint set at construction time (raised as Python exceptions instead of
stderr + NULL returns):

  * ``SavgolConfig``   — reference ``SavgolConfig``
    (reference include/iterative/savgolFilter.h:92-98, validation
    reference src/savgolFilter.c:639-677)
  * ``Savgol2DConfig`` — reference ``Savgol2DConfig``
    (reference include/iterative/savgol2d.h:82-90, validation
    reference src/savgol2d.c:271-302)
"""

from __future__ import annotations

import dataclasses
import enum

# Compile-time limits of the reference library
# (reference include/iterative/savgolFilter.h:38-48).
MAX_HALF_WINDOW = 32
MAX_WINDOW = 2 * MAX_HALF_WINDOW + 1
MAX_POLY_ORDER = 10
MAX_DERIVATIVE = 4

# 2D limits (reference include/iterative/savgol2d.h:63-73).
MAX_HALF_WINDOW_2D = 16
MAX_POLY_ORDER_2D = 6
MAX_TERMS_2D = (MAX_POLY_ORDER_2D + 1) * (MAX_POLY_ORDER_2D + 2) // 2


class BoundaryMode(enum.Enum):
    """Edge handling for 1D filtering.

    Mirrors ``SavgolBoundaryMode``
    (reference include/iterative/savgolFilter.h:63-68).

    POLYNOMIAL fits asymmetric polynomials near the edges (best feature
    preservation); the other three synthesize virtual samples beyond the
    array and reuse the centered stencil. Note the reference's REFLECT
    duplicates the edge sample (numpy ``symmetric``, *not* ``reflect``;
    reference src/savgolFilter.c:452-463).
    """

    POLYNOMIAL = "polynomial"
    REFLECT = "reflect"      # numpy pad mode: symmetric
    PERIODIC = "periodic"    # numpy pad mode: wrap
    CONSTANT = "constant"    # numpy pad mode: edge


# The one place the pad-boundary -> numpy/jnp pad-mode mapping lives
# (note REFLECT means the reference's edge-duplicating 'symmetric', NOT
# numpy 'reflect' — reference src/savgolFilter.c:452-463).
PAD_MODE = {
    BoundaryMode.REFLECT: "symmetric",
    BoundaryMode.PERIODIC: "wrap",
    BoundaryMode.CONSTANT: "edge",
}


class Boundary2D(enum.Enum):
    """Edge handling for the 2D filter.

    Mirrors ``Savgol2DBoundary``
    (reference include/iterative/savgol2d.h:108-112); PERIODIC
    (wrap-around, for cyclic/angular images — panoramas, polar grids)
    is an extension beyond the reference's boundary set, matching the
    1D ``BoundaryMode.PERIODIC``, supported on both the JAX paths and
    the native host engine.
    """

    VALID = "valid"
    CONSTANT = "constant"
    REFLECT = "reflect"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class SavgolConfig:
    """1D Savitzky-Golay filter parameters.

    Attributes:
      half_window: n; the window spans ``[-n, +n]`` (2n+1 points). 1..32.
      poly_order:  m; degree of the least-squares polynomial. m < 2n+1.
      derivative:  d; 0 = smooth, 1 = first derivative, ... d <= min(m, 4).
      time_step:   sample spacing; derivative outputs are scaled by
                   ``1 / time_step**derivative``.
      boundary:    edge-handling mode.
    """

    half_window: int
    poly_order: int
    derivative: int = 0
    time_step: float = 1.0
    boundary: BoundaryMode = BoundaryMode.POLYNOMIAL

    def __post_init__(self):
        n, m, d = self.half_window, self.poly_order, self.derivative
        if not 1 <= n <= MAX_HALF_WINDOW:
            raise ValueError(
                f"half_window must be in [1, {MAX_HALF_WINDOW}], got {n}")
        if not 0 <= m < 2 * n + 1:
            raise ValueError(
                f"poly_order must be in [0, window_size) = [0, {2 * n + 1}), got {m}")
        if m > MAX_POLY_ORDER:
            raise ValueError(
                f"poly_order must be <= {MAX_POLY_ORDER}, got {m}")
        if not 0 <= d <= MAX_DERIVATIVE:
            raise ValueError(
                f"derivative must be in [0, {MAX_DERIVATIVE}], got {d}")
        if d > m:
            raise ValueError(
                f"derivative ({d}) cannot exceed poly_order ({m})")
        if not self.time_step > 0.0:
            raise ValueError(f"time_step must be > 0, got {self.time_step}")
        if not isinstance(self.boundary, BoundaryMode):
            object.__setattr__(self, "boundary", BoundaryMode(self.boundary))

    @property
    def window_size(self) -> int:
        return 2 * self.half_window + 1

    @property
    def dt_scale(self) -> float:
        """``time_step ** derivative`` (reference src/savgolFilter.c:707)."""
        return float(self.time_step) ** int(self.derivative)


def smooth(half_window: int, poly_order: int) -> SavgolConfig:
    """Smoothing config (reference macro SAVGOL_SMOOTH, savgolFilter.h:209-212)."""
    return SavgolConfig(half_window, poly_order, derivative=0, time_step=1.0)


def deriv1(half_window: int, poly_order: int, dt: float = 1.0) -> SavgolConfig:
    """First-derivative config (reference macro SAVGOL_DERIV1, savgolFilter.h:214-217)."""
    return SavgolConfig(half_window, poly_order, derivative=1, time_step=dt)


def deriv2(half_window: int, poly_order: int, dt: float = 1.0) -> SavgolConfig:
    """Second-derivative config (reference macro SAVGOL_DERIV2, savgolFilter.h:219-222)."""
    return SavgolConfig(half_window, poly_order, derivative=2, time_step=dt)


def num_terms_2d(poly_order: int) -> int:
    """Number of 2D monomials x^i y^j with i+j <= order
    (reference include/iterative/savgol2d.h:261-264)."""
    return (poly_order + 1) * (poly_order + 2) // 2


@dataclasses.dataclass(frozen=True)
class Savgol2DConfig:
    """2D Savitzky-Golay filter parameters.

    Fits p(x, y) = sum a_ij x^i y^j (i+j <= poly_order) over a rectangular
    window spanning ``[-half_window_x, +half_window_x] x [-half_window_y,
    +half_window_y]`` and evaluates the requested partial derivative at the
    window center.
    """

    half_window_x: int
    half_window_y: int
    poly_order: int
    deriv_x: int = 0
    deriv_y: int = 0
    delta_x: float = 1.0
    delta_y: float = 1.0

    def __post_init__(self):
        if not 1 <= self.half_window_x <= MAX_HALF_WINDOW_2D:
            raise ValueError(
                f"half_window_x must be in [1, {MAX_HALF_WINDOW_2D}], "
                f"got {self.half_window_x}")
        if not 1 <= self.half_window_y <= MAX_HALF_WINDOW_2D:
            raise ValueError(
                f"half_window_y must be in [1, {MAX_HALF_WINDOW_2D}], "
                f"got {self.half_window_y}")
        if not 0 <= self.poly_order <= MAX_POLY_ORDER_2D:
            raise ValueError(
                f"poly_order must be in [0, {MAX_POLY_ORDER_2D}], "
                f"got {self.poly_order}")
        if self.deriv_x < 0 or self.deriv_y < 0:
            raise ValueError("derivative orders must be >= 0")
        if self.deriv_x + self.deriv_y > self.poly_order:
            raise ValueError(
                f"deriv_x + deriv_y ({self.deriv_x + self.deriv_y}) cannot "
                f"exceed poly_order ({self.poly_order})")
        if not (self.delta_x > 0.0 and self.delta_y > 0.0):
            raise ValueError("delta_x and delta_y must be > 0")
        if self.window_area < num_terms_2d(self.poly_order):
            raise ValueError(
                f"window area ({self.window_area}) must be >= number of "
                f"polynomial terms ({num_terms_2d(self.poly_order)})")

    @property
    def window_width(self) -> int:
        return 2 * self.half_window_x + 1

    @property
    def window_height(self) -> int:
        return 2 * self.half_window_y + 1

    @property
    def window_area(self) -> int:
        return self.window_width * self.window_height

    @property
    def num_terms(self) -> int:
        return num_terms_2d(self.poly_order)

    @property
    def scale(self) -> float:
        """``1 / (delta_x**deriv_x * delta_y**deriv_y)``
        (reference src/savgol2d.c:320-322)."""
        return 1.0 / (float(self.delta_x) ** int(self.deriv_x)
                      * float(self.delta_y) ** int(self.deriv_y))
