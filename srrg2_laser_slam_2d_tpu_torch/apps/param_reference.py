"""Parameter reference generator: the configuration registry's parameter
docs rendered as markdown (counterpart of
``srrg2_laser_slam_2d_tpu/apps/param_reference.py``; ``utils.config.describe``
is the single source of truth).

Usage: python -m srrg2_laser_slam_2d_tpu_torch.apps.param_reference [-o docs/PARAMETERS.md]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..utils import config as config_mod


def render() -> str:
    lines = ["# Parameter reference", "",
             "Generated from the component registry (`utils/config.py`).", ""]
    for name, cls in sorted(config_mod.registry().items()):
        if not dataclasses.is_dataclass(cls):
            continue
        lines += [f"## {name}", "", "| parameter | type | default | doc |", "|---|---|---|---|"]
        for p in config_mod.describe(name):
            default = p["default"]
            if dataclasses.is_dataclass(default) or hasattr(default, "_fields"):
                default = type(default).__name__ + "()"
            lines.append(f"| `{p['name']}` | {p['type']} | `{default}` | {p['doc']} |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--output", default="docs/PARAMETERS.md")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        f.write(render())
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
