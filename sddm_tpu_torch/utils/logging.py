"""Run-dir logging (counterpart of ``sddm_tpu/utils/logging.py``): a console
handler and a rotating ``info.log`` inside the run dir."""

from __future__ import annotations

import logging
import logging.config
from pathlib import Path

DEFAULT_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {
        "simple": {"format": "%(message)s"},
        "datetime": {"format": "%(asctime)s - %(name)s - %(levelname)s - %(message)s"},
    },
    "handlers": {
        "console": {
            "class": "logging.StreamHandler",
            "level": "DEBUG",
            "formatter": "simple",
            "stream": "ext://sys.stdout",
        },
        "info_file_handler": {
            "class": "logging.handlers.RotatingFileHandler",
            "level": "INFO",
            "formatter": "datetime",
            "filename": "info.log",
            "maxBytes": 10485760,
            "backupCount": 20,
            "encoding": "utf8",
        },
    },
    "root": {"level": "INFO", "handlers": ["console", "info_file_handler"]},
}


def setup_logging(save_dir) -> None:
    """Point the rotating file handler into ``save_dir`` and apply dictConfig."""
    config = {**DEFAULT_CONFIG}
    handlers = {k: dict(v) for k, v in config["handlers"].items()}
    for handler in handlers.values():
        if "filename" in handler:
            handler["filename"] = str(Path(save_dir) / handler["filename"])
    config["handlers"] = handlers
    logging.config.dictConfig(config)


LOG_LEVELS = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}


def get_logger(name: str, verbosity: int = 2) -> logging.Logger:
    if verbosity not in LOG_LEVELS:
        raise ValueError(f"verbosity {verbosity} invalid; valid: {list(LOG_LEVELS)}")
    logger = logging.getLogger(name)
    logger.setLevel(LOG_LEVELS[verbosity])
    return logger
