"""Console logger with optional color (port of ``ase_tpu/utils/logger.py``).

A small print logger: severity-tagged, in color when the stream is a TTY
and ``termcolor`` imports, plain otherwise.
"""

from __future__ import annotations

import sys
import time


class Logger:
    LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}
    COLORS = {"debug": "grey", "info": None, "warn": "yellow", "error": "red"}

    def __init__(self, level: str = "info", stream=None):
        self.level = self.LEVELS[level]
        self.stream = stream or sys.stdout
        try:
            from termcolor import colored
        except ImportError:
            colored = None
        self._colored = colored if colored is not None and self.stream.isatty() else None

    def _log(self, level: str, msg: str):
        if self.LEVELS[level] < self.level:
            return
        line = f"[{time.strftime('%H:%M:%S')}][{level}] {msg}"
        color = self.COLORS[level]
        if self._colored and color:
            line = self._colored(line, color)
        print(line, file=self.stream, flush=True)

    def debug(self, msg):
        self._log("debug", msg)

    def info(self, msg):
        self._log("info", msg)

    def warn(self, msg):
        self._log("warn", msg)

    def error(self, msg):
        self._log("error", msg)


logger = Logger()
