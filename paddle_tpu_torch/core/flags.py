"""Process-wide flag registry (the port's copy of paddle_tpu/core/flags.py).

Registered flags with defaults, an environment override at first read
(`FLAGS_<name>`), and `set_flags()` at run time. `FLAGS_check_nan_inf`
makes the op dispatch check every floating output (a host read an op).
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags",
           "list_flags"]

_FLAGS: Dict[str, Dict[str, Any]] = {}


def define_flag(name: str, default, doc: str = "", flag_type=None):
    if name in _FLAGS:
        return
    _FLAGS[name] = {"value": default, "default": default, "doc": doc,
                    "type": flag_type or type(default), "env_read": False}


def _coerce(value, flag_type):
    if flag_type is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    return flag_type(value)


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    out = {}
    for name in names:
        if name not in _FLAGS:
            raise KeyError(f"flag {name!r} is not registered")
        entry = _FLAGS[name]
        if not entry["env_read"]:
            env = os.environ.get(name if name.startswith("FLAGS_")
                                 else f"FLAGS_{name}")
            if env is not None:
                entry["value"] = _coerce(env, entry["type"])
            entry["env_read"] = True
        out[name] = entry["value"]
    return out


def get_flag(name: str):
    return get_flags(name)[name]


def set_flags(flags: Dict[str, Any]):
    for name, value in flags.items():
        if name not in _FLAGS:
            raise KeyError(f"flag {name!r} is not registered")
        entry = _FLAGS[name]
        entry["value"] = _coerce(value, entry["type"])
        entry["env_read"] = True


def list_flags():
    return {k: v["value"] for k, v in _FLAGS.items()}


define_flag("FLAGS_check_nan_inf", False,
            "check nan/inf on op outputs in eager mode")
define_flag("FLAGS_benchmark", False, "block on every op (debug timing)")
define_flag("FLAGS_use_amp_master_weight", True,
            "keep fp32 master weights under O2")
define_flag("FLAGS_log_level", 0, "framework log verbosity (GLOG_v analog)")
