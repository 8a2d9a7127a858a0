"""Render-configuration schema.

A declarative re-implementation of the reference's rapidjson validator layer
(reference rayverb/config.h:58-514 and the field registry in
cmd/main.cpp:139-207). Key names, required/optional split, defaults, enum
spellings — including the historical ``volumme_scale`` key — are preserved so
the 20 demo configs parse unchanged.

Documented deviations from the reference:
  - ``"hipass": false`` appears in three demo configs; the reference's float
    getter would reject it ("invalid value", config.h:483-490) and abort.
    Here a bool ``false`` keeps the default cutoff and emits a warning, so
    those configs render (SURVEY.md §5 records this choice).
"""

from __future__ import annotations

import enum
import json
import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import DEFAULT_HIPASS


class ConfigError(ValueError):
    """Raised on malformed config files; message style follows the
    reference's runtime_error texts."""


class FilterType(enum.Enum):
    """Crossover filter selection (config.h:326-330)."""

    WINDOWED_SINC = "sinc"
    BIQUAD_ONEPASS = "onepass"
    BIQUAD_TWOPASS = "twopass"
    LINKWITZ_RILEY = "linkwitz_riley"


class OutputMode(enum.Enum):
    """Which impulse populations reach the output (config.h:342-345)."""

    ALL = "all"
    IMAGE_ONLY = "image_only"
    DIFFUSE_ONLY = "diffuse_only"


@dataclass(frozen=True)
class Speaker:
    """A virtual microphone with a first-order polar pattern
    (clstructs.h:52-56): gain = (1-shape) + shape * cos(angle)."""

    direction: np.ndarray  # (3,) float32, not necessarily normalised
    shape: float           # 0 = omni, 0.5 = cardioid, 1 = bidirectional


@dataclass(frozen=True)
class HrtfConfig:
    """Head orientation for binaural rendering (rayverb.h:223-227);
    facing/up are stored normalised (config.h:395-408)."""

    facing: np.ndarray  # (3,) float32, unit
    up: np.ndarray      # (3,) float32, unit


@dataclass(frozen=True)
class AttenuationModel:
    """Exactly one of speakers / hrtf (config.h:433-476)."""

    speakers: tuple = ()
    hrtf: HrtfConfig | None = None

    @property
    def is_hrtf(self) -> bool:
        return self.hrtf is not None

    @property
    def num_channels(self) -> int:
        return 2 if self.is_hrtf else len(self.speakers)


@dataclass(frozen=True)
class RenderConfig:
    """Full render configuration (field registry: cmd/main.cpp:179-196,
    defaults: cmd/main.cpp:140-157)."""

    # required
    rays: int
    reflections: int
    sample_rate: float
    bit_depth: int
    source_position: np.ndarray  # (3,)
    mic_position: np.ndarray     # (3,)
    attenuation_model: AttenuationModel
    # optional
    filter: FilterType = FilterType.BIQUAD_ONEPASS
    hipass: float = DEFAULT_HIPASS
    normalize: bool = True
    volume_scale: float = 1.0
    trim_predelay: bool = False
    remove_direct: bool = False
    trim_tail: bool = True
    output_mode: OutputMode = OutputMode.ALL
    verbose: bool = False
    # framework extensions (not in the reference config surface)
    seed: int | None = None          # deterministic ray directions
    dump_paths: str | None = None    # JSONL diagnostic dump path
    warnings: tuple = field(default=(), compare=False)


def _require(doc: dict, key: str):
    if key not in doc:
        # reference RequiredValidator message (config.h:111)
        raise ConfigError(f"key {key} not found in config object")
    return doc[key]


def _as_number(value, key: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ConfigError(f"invalid value for key {key}")
    return float(value)


def _as_int(value, key: str) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise ConfigError(f"invalid value for key {key}")
    return int(value)


def _as_bool(value, key: str) -> bool:
    if not isinstance(value, bool):
        raise ConfigError(f"invalid value for key {key}")
    return value


def _as_float3(value, key: str) -> np.ndarray:
    if (
        not isinstance(value, (list, tuple))
        or len(value) != 3
        or any(isinstance(v, bool) or not isinstance(v, (int, float)) for v in value)
    ):
        raise ConfigError(f"invalid value for key {key}")
    return np.asarray(value, dtype=np.float32)


def _as_enum(value, key: str, enum_cls):
    if isinstance(value, str):
        for member in enum_cls:
            if member.value == value:
                return member
    raise ConfigError(f"invalid value for key {key}")


def _normalized(v: np.ndarray) -> np.ndarray:
    n = math.sqrt(float(np.dot(v, v)))
    if n == 0:
        raise ConfigError("invalid value: zero-length direction")
    return (v / n).astype(np.float32)


def _parse_speaker(value) -> Speaker:
    if not isinstance(value, dict):
        raise ConfigError("invalid value for speaker")
    direction = _as_float3(_require(value, "direction"), "direction")
    shape = _as_number(_require(value, "shape"), "shape")
    return Speaker(direction=direction, shape=shape)


def _parse_hrtf(value) -> HrtfConfig:
    if not isinstance(value, dict):
        raise ConfigError("invalid value for hrtf")
    facing = _normalized(_as_float3(_require(value, "facing"), "facing"))
    up = _normalized(_as_float3(_require(value, "up"), "up"))
    return HrtfConfig(facing=facing, up=up)


def _parse_attenuation_model(value) -> AttenuationModel:
    if not isinstance(value, dict):
        raise ConfigError("invalid value for key attenuation_model")
    has_speakers = "speakers" in value
    has_hrtf = "hrtf" in value
    # exactly one mode may be present (config.h:445-455)
    if has_speakers == has_hrtf:
        raise ConfigError("invalid value for key attenuation_model")
    if has_speakers:
        spk = value["speakers"]
        if not isinstance(spk, (list, tuple)):
            raise ConfigError("invalid value for key speakers")
        return AttenuationModel(speakers=tuple(_parse_speaker(s) for s in spk))
    return AttenuationModel(hrtf=_parse_hrtf(value["hrtf"]))


def parse_config(text: str) -> RenderConfig:
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ConfigError(f"Encountered error while parsing config file: {e}") from e
    if not isinstance(doc, dict):
        raise ConfigError("Rayverb config must be stored in a JSON object")

    warnings: list = []

    kwargs = dict(
        rays=_as_int(_require(doc, "rays"), "rays"),
        reflections=_as_int(_require(doc, "reflections"), "reflections"),
        sample_rate=_as_number(_require(doc, "sample_rate"), "sample_rate"),
        bit_depth=_as_int(_require(doc, "bit_depth"), "bit_depth"),
        source_position=_as_float3(_require(doc, "source_position"), "source_position"),
        mic_position=_as_float3(_require(doc, "mic_position"), "mic_position"),
        attenuation_model=_parse_attenuation_model(_require(doc, "attenuation_model")),
    )

    if "filter" in doc:
        kwargs["filter"] = _as_enum(doc["filter"], "filter", FilterType)
    if "hipass" in doc:
        if doc["hipass"] is False:
            warnings.append(
                "config sets 'hipass: false'; keeping default cutoff "
                f"{DEFAULT_HIPASS} Hz (the reference would reject this config)"
            )
        else:
            kwargs["hipass"] = _as_number(doc["hipass"], "hipass")
    if "normalize" in doc:
        kwargs["normalize"] = _as_bool(doc["normalize"], "normalize")
    if "volumme_scale" in doc:  # historical spelling (cmd/main.cpp:191)
        kwargs["volume_scale"] = _as_number(doc["volumme_scale"], "volumme_scale")
    if "trim_predelay" in doc:
        kwargs["trim_predelay"] = _as_bool(doc["trim_predelay"], "trim_predelay")
    if "remove_direct" in doc:
        kwargs["remove_direct"] = _as_bool(doc["remove_direct"], "remove_direct")
    if "trim_tail" in doc:
        kwargs["trim_tail"] = _as_bool(doc["trim_tail"], "trim_tail")
    if "output_mode" in doc:
        kwargs["output_mode"] = _as_enum(doc["output_mode"], "output_mode", OutputMode)
    if "verbose" in doc:
        kwargs["verbose"] = _as_bool(doc["verbose"], "verbose")
    # framework extensions
    if "seed" in doc and doc["seed"] is not None:
        kwargs["seed"] = _as_int(doc["seed"], "seed")

    return RenderConfig(warnings=tuple(warnings), **kwargs)


def load_config(path: str) -> RenderConfig:
    with open(path, "r") as fh:
        return parse_config(fh.read())
