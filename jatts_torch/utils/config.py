"""Flat-YAML + CLI-overlay config contract (counterpart of
jatts_tpu/utils/config.py): the experiment yaml is a flat dict, overlaid
with the CLI's arguments, and dumped to ``outdir/config.yml``."""

from __future__ import annotations

import os
from typing import Any, Dict


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.load(f, Loader=yaml.SafeLoader)


def dump_config(config: Dict[str, Any], path: str) -> None:
    """Write the yaml-representable entries of ``config`` to ``path``."""
    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    clean = {k: v for k, v in config.items() if _yaml_safe(v)}
    with open(path, "w") as f:
        yaml.dump(clean, f, Dumper=yaml.SafeDumper, default_flow_style=False)


def _yaml_safe(v: Any) -> bool:
    if isinstance(v, (str, int, float, bool, type(None))):
        return True
    if isinstance(v, (list, tuple)):
        return all(_yaml_safe(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _yaml_safe(x) for k, x in v.items())
    return False
