"""Run configuration: three sections (model / datasets / run) with
dotlist overrides and eager validation.

The PyTorch port's copy of ``libra_tpu/run_config.py``. A config is a
dict: ``RunConfig.from_dict(cfg, options)`` needs no PyYAML, so it runs
where PyYAML is absent (the card); ``RunConfig(path, options)`` reads a
YAML file and goes through it. Override values are parsed as YAML
scalars, as in libra_tpu, so `--options` needs PyYAML; both import it
where they parse.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from libra_tpu_torch.registry import registry


def _parse_value(v: str) -> Any:
    import yaml
    return yaml.safe_load(v)


def parse_dotlist(options: Optional[List[str]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"override {opt!r} is not key=value")
        key, val = opt.split("=", 1)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return out


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class RunConfig:
    def __init__(self, cfg_path: str, options: Optional[List[str]] = None):
        import yaml
        with open(cfg_path) as f:
            cfg = yaml.safe_load(f) or {}
        self._load(cfg, options)

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any],
                  options: Optional[List[str]] = None) -> "RunConfig":
        """A run config from a dict of the three sections (what the YAML
        file holds), with dotlist overrides."""
        self = cls.__new__(cls)
        self._load(cfg, options)
        return self

    def _load(self, cfg: Dict[str, Any], options: Optional[List[str]]) -> None:
        cfg = deep_merge(cfg or {}, parse_dotlist(options))
        self.config = cfg
        self.model_cfg: Dict[str, Any] = cfg.get("model", {})
        self.datasets_cfg: Dict[str, Any] = cfg.get("datasets", {})
        self.run_cfg: Dict[str, Any] = cfg.get("run", {})
        self.validate()

    def validate(self) -> None:
        arch = self.model_cfg.get("arch")
        if arch is not None:
            registry.get_model_class(arch)  # raises with options listed
        for name in self.datasets_cfg:
            registry.get_builder_class(name)
        pretrained = self.model_cfg.get("pretrained")
        if pretrained is not None and not Path(pretrained).exists():
            raise FileNotFoundError(
                f"model.pretrained path does not exist: {pretrained}")

    def pretty(self) -> str:
        import yaml
        return yaml.safe_dump(self.config, sort_keys=False)
