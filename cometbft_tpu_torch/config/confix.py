"""Confix: migrate a config file across framework versions.

Reference: internal/confix — loads an existing config.toml (any vintage),
carries every recognized key into a freshly rendered current template,
reports unknown keys, and backs up the original.

The port's copy of the JAX package's ``config/confix.py``.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import fields, is_dataclass

from cometbft_tpu_torch.config import config as cfgmod


def upgrade(home: str, dry_run: bool = False) -> dict:
    """Upgrade <home>/config/config.toml in place.  Returns a report:
    {carried: [...], unknown: [...], backup: path|None}."""
    path = os.path.join(home, "config", "config.toml")
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    old = cfgmod.load_config(home)  # tolerant: unknown keys are dropped
    current = cfgmod.default_config()

    carried: list[str] = []
    # top-level (base) fields first, then each section
    default_base = cfgmod.BaseConfig()
    for f in fields(cfgmod.BaseConfig):
        old_val = getattr(old.base, f.name)
        if f.name != "home" and old_val != getattr(default_base, f.name):
            setattr(current.base, f.name, old_val)
            carried.append(f.name)
    # copy every known field that differs from the default
    for section_name, section_cls in cfgmod._SECTIONS.items():
        old_sec = getattr(old, section_name)
        new_sec = getattr(current, section_name)
        default_sec = section_cls()
        if not is_dataclass(old_sec):
            continue
        for f in fields(section_cls):
            old_val = getattr(old_sec, f.name)
            if old_val != getattr(default_sec, f.name):
                setattr(new_sec, f.name, old_val)
                carried.append(f"{section_name}.{f.name}")

    unknown = _unknown_keys(path)
    report = {"carried": carried, "unknown": unknown, "backup": None}
    if dry_run:
        return report

    backup = path + ".bak"
    shutil.copyfile(path, backup)
    report["backup"] = backup
    cfgmod.write_config(
        current, os.path.join(home, "config", "config.toml")
    )
    return report


def _unknown_keys(path: str) -> list[str]:
    """TOML keys in the file that the current schema doesn't know."""
    known: dict[str, set[str]] = {
        name: {f.name for f in fields(cls)}
        for name, cls in cfgmod._SECTIONS.items()
    }
    known[""] = {f.name for f in fields(cfgmod.BaseConfig)}
    unknown = []
    section = ""
    with open(path) as fobj:
        for line in fobj:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1]
                continue
            if "=" in line:
                key = line.split("=", 1)[0].strip()
                sec_known = known.get(section)
                # TOML drops the trailing underscore of keyword-collision
                # fields (type_ -> type)
                if sec_known is not None and not (
                    key in sec_known or key + "_" in sec_known
                ):
                    unknown.append(f"{section + '.' if section else ''}{key}")
    return unknown
