"""Config resolution with the reference's precedence (copy of
expann_tpu/utils/config.py).

Counterpart of the reference CLI parameter system (reference:
src/main.cpp:18-50): a parameter is taken from (1) a ``--name value`` CLI
flag, else (2) the JSON config file (``--config``, default config.json),
else (3) an interactive prompt.
"""

from __future__ import annotations

import json
import sys
from typing import Any, List, Optional


def get_command_line_option(argv: List[str], option: str) -> Optional[str]:
    if option in argv:
        i = argv.index(option)
        if i + 1 < len(argv):
            return argv[i + 1]
    return None


def load_config_file(argv: List[str], default: str = "config.json") -> dict:
    filename = get_command_line_option(argv, "--config") or default
    try:
        with open(filename) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


_MISSING = object()


def get_parameter(
    argv: List[str],
    config: dict,
    name: str,
    prompt: str,
    cast=str,
    interactive: bool = True,
    default: Any = _MISSING,
) -> Any:
    cli = get_command_line_option(argv, "--" + name)
    if cli is not None:
        return cast(cli)
    if name in config:
        return cast(config[name])
    if not interactive:
        if default is not _MISSING:
            return default
        raise KeyError(f"missing required parameter: {name}")
    sys.stdout.write(prompt)
    sys.stdout.flush()
    return cast(input())
