"""Deterministic shake synthesis -> motion_meta v2.

A copy of ``comfyui_video_stabilizer_tpu/models/shake.py`` (numpy only,
the same code line for line; tests/test_torch_host_copies.py holds the
JSON of both byte-identical).

The generator math runs on host in numpy ON PURPOSE: the compatibility
contract (the reference's nodes/shake_noise.py and its
docs/requirements/004) pins the ``np.random.default_rng(seed)``
consumption order — drift pan/tilt/roll/zoom, tremor pan/tilt/roll/
zoom, jitter, walking step — so the same (frame_count, w, h, fps,
recipe, amount, speed, seed) must yield byte-identical JSON across
machines.  The synthesis is O(N) scalars; only the matrix *application*
belongs on the device (via ops/warp, driven by Motion Apply).

Components model a pinhole camera: pan/tilt in degrees become pixel
translations through the virtual-FOV focal length; roll/zoom form a
center-pivot similarity (T @ R*S @ T^-1).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict

import numpy as np

from .geometry import translation_matrix  # noqa: F401  (re-export convenience)
from ..meta.motion_meta import build_motion_meta_v2


@dataclass(frozen=True)
class ShakeRecipe:
    pan: float
    tilt: float
    roll: float
    zoom: float
    drift_freq: float
    tremor: float
    tremor_freq: float
    jitter_rate: float
    step: float
    randomness: float
    virtual_fov: float


# Style presets (docs/requirements/004 of the reference, table at :98-104).
STYLES: Dict[str, ShakeRecipe] = {
    "tripod": ShakeRecipe(0.03, 0.03, 0.02, 0.0002, 0.20, 0.15, 4.0, 0.0, 0.0, 0.3, 60.0),
    "handheld": ShakeRecipe(0.40, 0.33, 0.50, 0.0030, 0.35, 0.35, 5.0, 0.0, 0.0, 0.3, 60.0),
    "walking": ShakeRecipe(0.46, 0.60, 0.70, 0.0040, 0.30, 0.30, 5.0, 0.0, 0.60, 0.3, 60.0),
    "action": ShakeRecipe(0.80, 0.66, 1.00, 0.0060, 0.50, 0.80, 6.0, 0.5, 0.0, 0.3, 60.0),
    "vibration": ShakeRecipe(0.15, 0.15, 0.10, 0.0010, 0.00, 1.00, 8.0, 0.0, 0.0, 0.3, 60.0),
}


@dataclass(frozen=True)
class ShakeComponents:
    pan_deg: np.ndarray
    tilt_deg: np.ndarray
    roll_deg: np.ndarray
    zoom_log: np.ndarray


def recipe_to_dict(recipe: ShakeRecipe) -> dict[str, float]:
    return {key: float(value) for key, value in asdict(recipe).items()}


def clamp_recipe(recipe: ShakeRecipe) -> ShakeRecipe:
    return ShakeRecipe(
        pan=float(np.clip(recipe.pan, 0.0, 5.0)),
        tilt=float(np.clip(recipe.tilt, 0.0, 5.0)),
        roll=float(np.clip(recipe.roll, 0.0, 5.0)),
        zoom=float(np.clip(recipe.zoom, 0.0, 0.05)),
        drift_freq=float(np.clip(recipe.drift_freq, 0.0, 2.0)),
        tremor=float(np.clip(recipe.tremor, 0.0, 2.0)),
        tremor_freq=float(np.clip(recipe.tremor_freq, 1.0, 15.0)),
        jitter_rate=float(np.clip(recipe.jitter_rate, 0.0, 3.0)),
        step=float(np.clip(recipe.step, 0.0, 2.0)),
        randomness=float(np.clip(recipe.randomness, 0.0, 1.0)),
        virtual_fov=float(np.clip(recipe.virtual_fov, 10.0, 120.0)),
    )


def recipe_from_mapping(value: dict[str, object]) -> ShakeRecipe:
    return clamp_recipe(
        ShakeRecipe(**{field: float(value[field]) for field in ShakeRecipe.__dataclass_fields__})
    )


# ---------------------------------------------------------------------------
# Noise primitives
# ---------------------------------------------------------------------------

def _catmull_rom(p0, p1, p2, p3, u):
    u2 = u * u
    u3 = u2 * u
    return 0.5 * (
        (2.0 * p1)
        + (-p0 + p2) * u
        + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * u2
        + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * u3
    )


def _smooth_value_noise(rng: np.random.Generator, frame_count: int, fps: float, frequency: float) -> np.ndarray:
    """Catmull-Rom interpolated value noise, Nyquist-clamped frequency."""
    if frame_count <= 0:
        return np.zeros((0,), dtype=np.float64)
    frequency = float(min(max(frequency, 1e-6), max(fps * 0.5, 1e-6)))
    duration = max((frame_count - 1) / fps, 0.0)
    control_count = max(4, math.ceil(duration * frequency) + 5)
    controls = rng.standard_normal(control_count).astype(np.float64)
    positions = np.arange(frame_count, dtype=np.float64) * frequency / fps
    base = np.floor(positions).astype(np.int64) + 1
    u = positions - np.floor(positions)
    base = np.clip(base, 1, control_count - 3)
    return _catmull_rom(controls[base - 1], controls[base], controls[base + 1], controls[base + 2], u)


def _zero_start(values: np.ndarray) -> np.ndarray:
    if values.size:
        return values - float(values[0])
    return values


def _modulated_noise(
    rng: np.random.Generator,
    frame_count: int,
    fps: float,
    frequency: float,
    speed: float,
    randomness: float,
) -> np.ndarray:
    base = _smooth_value_noise(rng, frame_count, fps, frequency * speed)
    if frame_count <= 0 or randomness <= 0.0:
        return base
    modulation = _smooth_value_noise(rng, frame_count, fps, 0.2 * speed)
    modulation = modulation / max(float(np.max(np.abs(modulation))), 1e-6)
    envelope = np.clip(1.0 + modulation * randomness, 0.0, 2.0)
    return base * envelope


def _jitter_events(rng, frame_count: int, fps: float, rate: float, speed: float):
    """Poisson impulse train with exp(-t/0.1s) decay, vectorized over events."""
    zeros = np.zeros((frame_count,), dtype=np.float64)
    if frame_count <= 0 or rate <= 0.0:
        return zeros.copy(), zeros.copy(), zeros.copy()
    duration = frame_count / fps
    event_count = int(rng.poisson(rate * speed * duration))
    if event_count <= 0:
        return zeros.copy(), zeros.copy(), zeros.copy()
    times = rng.uniform(0.0, duration, size=event_count)
    amplitudes = rng.standard_normal((event_count, 3)).astype(np.float64)
    t = np.arange(frame_count, dtype=np.float64) / fps
    dt = t[None, :] - times[:, None]                       # (E, N)
    envelope = np.where(dt >= 0.0, np.exp(-dt / 0.1), 0.0)
    mixed = amplitudes.T @ envelope                        # (3, N)
    return mixed[0], mixed[1], mixed[2]


def _walking_step(rng, frame_count: int, fps: float, speed: float, randomness: float):
    """Gait sinusoids at 1.9*speed Hz with half-rate sway/roll."""
    zeros = np.zeros((frame_count,), dtype=np.float64)
    if frame_count <= 0:
        return zeros.copy(), zeros.copy(), zeros.copy()
    t = np.arange(frame_count, dtype=np.float64) / fps
    phase = float(rng.uniform(0.0, 2.0 * math.pi))
    amp_noise = _smooth_value_noise(rng, frame_count, fps, 0.25 * speed)
    amp_noise = amp_noise / max(float(np.max(np.abs(amp_noise))), 1e-6)
    envelope = np.clip(1.0 + amp_noise * randomness, 0.0, 2.0)
    step_freq = 1.9 * speed
    tilt = np.sin(2.0 * math.pi * step_freq * t + phase) * envelope
    sway = np.sin(2.0 * math.pi * (step_freq * 0.5) * t + phase * 0.73) * envelope
    roll = np.sin(2.0 * math.pi * (step_freq * 0.5) * t + phase * 1.31) * envelope
    return sway, tilt, roll


# ---------------------------------------------------------------------------
# Component mixing and projection
# ---------------------------------------------------------------------------

def generate_shake_components(
    *,
    recipe: ShakeRecipe,
    frame_count: int,
    fps: float,
    amount: float,
    speed: float,
    seed: int,
) -> ShakeComponents:
    recipe = clamp_recipe(recipe)
    frame_count = int(frame_count)
    fps = float(max(1.0, fps))
    amount = float(np.clip(amount, 0.0, 3.0))
    speed = float(np.clip(speed, 0.1, 3.0))
    if frame_count < 0:
        raise ValueError("frame_count must be non-negative.")

    rng = np.random.default_rng(int(seed))
    zeros = np.zeros((frame_count,), dtype=np.float64)

    # RNG consumption order is a compatibility contract:
    # drift pan/tilt/roll/zoom -> tremor pan/tilt/roll/zoom -> jitter -> step.
    if recipe.drift_freq > 0.0:
        drift = [
            _modulated_noise(rng, frame_count, fps, recipe.drift_freq, speed, recipe.randomness)
            for _ in range(4)
        ]
    else:
        drift = [zeros] * 4
    tremor = [
        _modulated_noise(rng, frame_count, fps, recipe.tremor_freq, speed, recipe.randomness)
        for _ in range(4)
    ]
    jitter_pan, jitter_tilt, jitter_roll = _jitter_events(
        rng, frame_count, fps, recipe.jitter_rate, speed
    )
    if recipe.step > 0.0:
        step_pan, step_tilt, step_roll = _walking_step(rng, frame_count, fps, speed, recipe.randomness)
    else:
        step_pan = step_tilt = step_roll = zeros

    pan = (
        drift[0] * recipe.pan
        + tremor[0] * recipe.pan * recipe.tremor
        + jitter_pan * recipe.pan
        + step_pan * recipe.step * 0.5
    )
    tilt = (
        drift[1] * recipe.tilt
        + tremor[1] * recipe.tilt * recipe.tremor
        + jitter_tilt * recipe.tilt
        + step_tilt * recipe.step
    )
    roll = (
        drift[2] * recipe.roll
        + tremor[2] * recipe.roll * recipe.tremor
        + jitter_roll * recipe.roll
        + step_roll * recipe.step * 0.5
    )
    zoom = drift[3] * recipe.zoom + tremor[3] * recipe.zoom * recipe.tremor

    return ShakeComponents(
        pan_deg=_zero_start(pan * amount),
        tilt_deg=_zero_start(tilt * amount),
        roll_deg=_zero_start(roll * amount),
        zoom_log=_zero_start(zoom * amount),
    )


def shake_matrices(
    width: int,
    height: int,
    components: ShakeComponents,
    virtual_fov: float,
) -> np.ndarray:
    """Project angle/zoom channels into (N, 3, 3) matrices, vectorized.

    Pinhole model: f = 0.5*min(w,h)/tan(fov/2); tx = f*tan(pan),
    ty = f*tan(tilt); roll/zoom are a similarity pivoting on the frame
    center:  T(c + t) @ [R*S] @ T(-c).
    """
    n = components.pan_deg.shape[0]
    cx, cy = width * 0.5, height * 0.5
    fov_rad = math.radians(float(np.clip(virtual_fov, 10.0, 120.0)))
    focal_px = 0.5 * min(width, height) / math.tan(fov_rad * 0.5)
    tx = focal_px * np.tan(np.radians(components.pan_deg))
    ty = focal_px * np.tan(np.radians(components.tilt_deg))
    angle = np.radians(components.roll_deg)
    cos_a, sin_a = np.cos(angle), np.sin(angle)
    scale = np.exp(components.zoom_log)

    mats = np.zeros((n, 3, 3), dtype=np.float64)
    a = scale * cos_a
    b = scale * sin_a
    mats[:, 0, 0] = a
    mats[:, 0, 1] = -b
    mats[:, 1, 0] = b
    mats[:, 1, 1] = a
    mats[:, 2, 2] = 1.0
    # Fold T(c+t) @ M @ T(-c) translation column in closed form.
    mats[:, 0, 2] = cx + tx - (a * cx - b * cy)
    mats[:, 1, 2] = cy + ty - (b * cx + a * cy)
    return mats


def generate_shake_motion_meta(
    *,
    recipe: ShakeRecipe,
    frame_count: int,
    width: int,
    height: int,
    fps: float,
    amount: float,
    speed: float,
    seed: int,
    node: str = "shake_generator",
    style: str = "manual",
) -> dict:
    recipe = clamp_recipe(recipe)
    frame_count = int(frame_count)
    width = int(width)
    height = int(height)
    fps = float(max(1.0, fps))
    if frame_count < 0 or width <= 0 or height <= 0:
        raise ValueError("frame_count must be non-negative and width/height must be positive.")

    amount = float(np.clip(amount, 0.0, 3.0))
    speed = float(np.clip(speed, 0.1, 3.0))
    components = generate_shake_components(
        recipe=recipe,
        frame_count=frame_count,
        fps=fps,
        amount=amount,
        speed=speed,
        seed=seed,
    )
    matrices = shake_matrices(width, height, components, recipe.virtual_fov)

    return build_motion_meta_v2(
        source="generated_shake",
        frame_count=frame_count,
        fps=fps,
        input_size=(width, height),
        output_size=(width, height),
        matrices=list(matrices),
        generator={
            "node": node,
            "style": style,
            "amount": amount,
            "speed": speed,
            "seed": int(seed),
            "recipe": recipe_to_dict(recipe),
        },
    )
