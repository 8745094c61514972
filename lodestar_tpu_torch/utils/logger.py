"""Structured logger with per-module children, a copy of
`lodestar_tpu/utils/logger.py` whose root is the stdlib logger
"lodestar_tpu_torch".

Mirror of the reference's `@lodestar/logger` (reference:
packages/logger/src/{node,winston}.ts): leveled, timestamped lines with
a module tag and key=value context, child loggers inheriting the parent
module path, optional file sink.  Built on stdlib logging (the host
runtime's native transport) rather than a winston translation.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional


class Logger:
    """`logger.child("chain").info("imported block", slot=5)` ->
    `[chain]  info: imported block slot=5`."""

    def __init__(
        self,
        module: str = "",
        level: str = "info",
        _base: Optional[logging.Logger] = None,
    ):
        self.module = module
        if _base is not None:
            self._log = _base
        else:
            self._log = logging.getLogger("lodestar_tpu_torch")
            self._log.setLevel(getattr(logging, level.upper()))
            if not self._log.handlers:
                h = logging.StreamHandler(sys.stderr)
                h.setFormatter(
                    logging.Formatter(
                        "%(asctime)s.%(msecs)03d %(message)s", "%H:%M:%S"
                    )
                )
                self._log.addHandler(h)

    def add_file_sink(self, path: str) -> None:
        h = logging.FileHandler(path)
        h.setFormatter(
            logging.Formatter("%(asctime)s.%(msecs)03d %(message)s", "%H:%M:%S")
        )
        self._log.addHandler(h)

    def child(self, module: str) -> "Logger":
        full = f"{self.module}/{module}" if self.module else module
        return Logger(full, _base=self._log)

    def _fmt(self, level: str, msg: str, ctx: dict) -> str:
        tag = f"[{self.module}]" if self.module else ""
        kv = " ".join(f"{k}={v}" for k, v in ctx.items())
        return f"{tag:<12} {level}: {msg}" + (f" {kv}" if kv else "")

    def error(self, msg: str, **ctx) -> None:
        self._log.error(self._fmt("error", msg, ctx))

    def warn(self, msg: str, **ctx) -> None:
        self._log.warning(self._fmt(" warn", msg, ctx))

    def info(self, msg: str, **ctx) -> None:
        self._log.info(self._fmt(" info", msg, ctx))

    def debug(self, msg: str, **ctx) -> None:
        self._log.debug(self._fmt("debug", msg, ctx))

    def verbose(self, msg: str, **ctx) -> None:
        self._log.debug(self._fmt("verbose", msg, ctx))


_root: Optional[Logger] = None


def get_logger(module: str = "", level: str = "info") -> Logger:
    global _root
    if _root is None:
        _root = Logger(level=level)
    return _root.child(module) if module else _root
