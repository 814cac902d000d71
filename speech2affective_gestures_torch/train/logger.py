"""Work-dir logging (the reference's torchlight IO helper,
`torchlight/torchlight/io.py`): print_log to stdout and log.txt, and the
save_arg session dump (config + command line as YAML).
"""

from __future__ import annotations

import os
import sys
import time

import yaml


class TrainLogger:
    """Logs to stdout and `work_dir/log.txt`; with `enabled` false (a
    data-parallel rank other than 0) it writes nothing."""

    def __init__(self, work_dir: str, enabled: bool = True):
        self.work_dir = work_dir
        self.enabled = enabled
        os.makedirs(work_dir, exist_ok=True)

    def print_log(self, msg: str):
        if not self.enabled:
            return
        msg = time.strftime("[ %a %b %d %H:%M:%S %Y ] ", time.localtime()) + msg
        print(msg)
        with open(os.path.join(self.work_dir, "log.txt"), "a") as f:
            f.write(msg + "\n")

    def save_arg(self, arg_obj):
        """Session dump (torchlight io.py:109-119)."""
        if not self.enabled:
            return
        arg_dict = (
            vars(arg_obj) if not isinstance(arg_obj, dict) else dict(arg_obj)
        )
        with open(os.path.join(self.work_dir, "config.yaml"), "w") as f:
            f.write(f"# command line: {' '.join(sys.argv)}\n\n")
            yaml.dump(
                {k: v for k, v in arg_dict.items()
                 if isinstance(v, (int, float, str, bool, list, tuple, type(None)))},
                f, default_flow_style=False, indent=4,
            )
