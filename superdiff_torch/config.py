"""Typed configuration tree and ``config.yaml`` I/O.

A copy of the dataclasses of ``superdiff_tpu/config.py`` (that module is
pure Python, but importing it pulls jax in through the package's
``__init__``). PyYAML is not assumed: :func:`load_config` reads, and
:func:`save_config` writes, the YAML subset the JAX package's
``save_config`` emits (``yaml.safe_dump(..., sort_keys=False)``): nested
block mappings, block sequences, flow ``[]``/``{}`` and ``[a, b]``, and
plain or quoted YAML 1.1 scalars (null, booleans, ints, floats, strings).
"""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a YAML/CLI value to the annotated field type."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0])
    if typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        return str(value).strip().lower() not in ("false", "0", "no", "off",
                                                  "none", "")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    if origin in (tuple, Tuple):
        args = typing.get_args(typ)
        elt = args[0] if args else str
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        elif not isinstance(value, (list, tuple)):
            value = [value]
        return tuple(_coerce(v, elt) for v in value)
    if origin in (list, List):
        args = typing.get_args(typ)
        elt = args[0] if args else str
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        return [_coerce(v, elt) for v in value]
    return value


@dataclass
class TrainingConfig:
    batch_size: int = 8
    num_epochs: int = 100
    num_timesteps: int = 1000
    schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    augmentation: str = "low"
    normalization: str = "tanh"
    split: str = "train"
    resolution: int = 64
    resize_strategy: str = "pad"
    histogram_equalization: bool = False
    learning_rate: float = 2e-4
    grad_accum: int = 1
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    ema_decay: float = 0.995
    loss_type: str = "mse"
    loss_weighting: str = "none"
    min_snr_gamma: float = 5.0
    cfg_drop_prob: float = 0.1
    class_filter: Optional[int] = None
    log_every: int = 1
    vis_every: int = 5
    save_every: int = 1
    eval_every: int = 1
    eval_batches: Optional[int] = None
    keep_checkpoints: int = 3
    seed: int = 42
    num_epochs_warmstart: int = 0
    steps_per_epoch: Optional[int] = None
    use_native_loader: bool = True


@dataclass
class ModelConfig:
    preset: str = "small64"
    num_classes: int = 2
    conditional: bool = True
    compute_dtype: str = "bfloat16"     # bfloat16|float32
    norm_dtype: str = "bfloat16"        # bfloat16|float32 (training passes)
    base_channels: Optional[int] = None
    num_res_blocks: Optional[Tuple[int, ...]] = None
    attn_resolutions: Optional[Tuple[int, ...]] = None
    dropout: float = 0.0
    remat: bool = False
    parameterization: str = "eps"       # eps|v|x0


@dataclass
class SamplingConfig:
    method: str = "ddpm"                # ddpm|ddim|dpmpp
    num_steps: int = 1000
    eta: float = 0.0
    guidance_scale: float = 1.0
    batch_size: int = 8
    num_batches: int = 1
    clip_x0: bool = True
    label: Optional[int] = None
    t_spacing: str = "leading"          # leading|trailing


@dataclass
class SuperDiffConfig:
    mode: str = "or"                    # or|and|fixed
    temperature: float = 1.0
    kappa: Tuple[float, ...] = (0.5, 0.5)
    bias: Tuple[float, ...] = (0.0, 0.0)


@dataclass
class LoggingConfig:
    use_wandb: bool = False
    use_tensorboard: bool = False
    use_jsonl: bool = True
    stdout: bool = True
    wandb_project: str = "super-diff-xray"
    profile_steps: int = 0


@dataclass
class PathsConfig:
    cluster_base: str = "/datasets/cluster"
    local_base: str = "data"
    dataset_subdir: str = "chest_xray"
    output_dir: str = "outputs"
    checkpoint_dir: str = "checkpoints"
    tensorboard_dir: str = "tensorboard"
    wandb_dir: str = "wandb"


@dataclass
class VizConfig:
    show_class_counts: bool = False
    show_batch: bool = False
    show_augmented: bool = False
    tsne: bool = False
    tsne_thumbnails: bool = False
    tsne_umap_thumbnails: bool = False
    projection_3d: bool = False
    projection_3d_thumbnails: bool = False
    projection_3d_plotly: bool = False
    gradcam: bool = False
    histograms: bool = False
    image_grid: bool = False


@dataclass
class Config:
    task: str = "PNEUMONIA"
    dataset: str = "PNEUMONIA"
    experiment_id: str = "exp0"
    run_id: str = "run0"
    training: TrainingConfig = field(default_factory=TrainingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    superdiff: SuperDiffConfig = field(default_factory=SuperDiffConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    viz: VizConfig = field(default_factory=VizConfig)


# ------------------------------------------------------------- YAML subset

# YAML 1.1 implicit scalar rules, as PyYAML's SafeLoader resolves them.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _parse_scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return bytes(s[1:-1], "utf-8").decode("unicode_escape")
    if s == "[]":
        return []
    if s == "{}":
        return {}
    if s.startswith("[") and s.endswith("]"):
        return [_parse_scalar(v) for v in _split_flow(s[1:-1])]
    if _NULL.match(s):
        return None
    if _BOOL_TRUE.match(s):
        return True
    if _BOOL_FALSE.match(s):
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s.startswith("-") else math.inf
    if _NAN.match(s):
        return math.nan
    return s


def _split_flow(body: str) -> List[str]:
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    return [i.strip() for i in items]


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str):
    """``key: rest`` -> (key, rest); None when the line is not a mapping
    entry (a colon must be followed by a space or end the line)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = _parse_scalar(text[:i])
            return str(key) if key is not None else "", text[i + 1:].strip()
    return None


def parse_yaml(text: str) -> Any:
    """Parse the block-style YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unparsed YAML from line {pos}: {lines[pos][1]!r}")
    return value


def _parse_block(lines, pos, indent):
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            item = lines[pos][1][1:].strip()
            pos += 1
            if item:
                out.append(_parse_scalar(item))
            else:
                val, pos = _parse_block(lines, pos, lines[pos][0])
                out.append(val)
        return out, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _split_key(lines[pos][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        key, rest = kv
        pos += 1
        if rest:
            out[key] = _parse_scalar(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("-"))):
            out[key], pos = _parse_block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def _format_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r and "e" in r:           # 1e-05 -> 1.0e-05 (YAML 1.1)
            r = r.replace("e", ".0e", 1)
        return r
    s = str(v)
    plain_ok = (s and s == s.strip() and _parse_scalar(s) == s
                and not re.search(r"[:#\[\]{},&*!|>'\"%@`]", s)
                and s[0] not in "-?")
    return s if plain_ok else "'" + s.replace("'", "''") + "'"


def dump_yaml(data: Dict[str, Any]) -> str:
    """Write nested dicts / lists / scalars in the subset :func:`parse_yaml`
    reads (and PyYAML's ``safe_load`` reads identically)."""
    out: List[str] = []

    def emit(obj, indent):
        pad = " " * indent
        for k, v in obj.items():
            if isinstance(v, dict) and v:
                out.append(f"{pad}{k}:")
                emit(v, indent + 2)
            elif isinstance(v, (list, tuple)) and len(v):
                out.append(f"{pad}{k}:")
                for item in v:
                    out.append(f"{pad}- {_format_scalar(item)}")
            elif isinstance(v, (list, tuple)):
                out.append(f"{pad}{k}: []")
            elif isinstance(v, dict):
                out.append(f"{pad}{k}: {{}}")
            else:
                out.append(f"{pad}{k}: {_format_scalar(v)}")

    emit(data, 0)
    return "\n".join(out) + "\n"


# --------------------------------------------------------------- load/save

def _update_dataclass(obj: Any, data: Dict[str, Any], path: str = "") -> None:
    valid = {f.name: f for f in fields(obj)}
    hints = typing.get_type_hints(type(obj))
    for key, value in data.items():
        if key not in valid:
            raise KeyError(f"unknown config key: {path}{key}")
        current = getattr(obj, key)
        if is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value, path=f"{path}{key}.")
        else:
            setattr(obj, key, _coerce(value, hints[key]))


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> Config:
    """Build a Config from an optional YAML file plus ``key.path=value``
    override strings (CLI surface)."""
    cfg = Config()
    if yaml_path:
        with open(yaml_path) as fh:
            data = parse_yaml(fh.read()) or {}
        _update_dataclass(cfg, data)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key.path=value, got {ov!r}")
        key, value = ov.split("=", 1)
        parts = key.strip().split(".")
        node: Dict[str, Any] = {}
        leaf = node
        for p in parts[:-1]:
            leaf[p] = {}
            leaf = leaf[p]
        leaf[parts[-1]] = _parse_scalar(value)
        _update_dataclass(cfg, node)
    return cfg


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    """Snapshot the effective config as ``config.yaml``."""
    with open(path, "w") as fh:
        fh.write(dump_yaml(to_dict(cfg)))
