"""JSON config system (counterpart of ``sddm_tpu/utils/config.py``).

The same JSON schema as the shipped configs, the same run-dir layout
``<trainer.save_dir>/<name>/<run_id>/`` with a config snapshot, the same
``target='optimizer;args;lr'`` key-path overrides from the command line and
the same resume-config merge for fine-tuning.  ``init_obj`` resolves
constructors from an explicit registry dict.  The ``-d`` flag selects the
torch device (``cpu``, ``cuda``, ``cuda:1``); bare GPU indices, the
reference's ``CUDA_VISIBLE_DEVICES`` use, are accepted and ignored.
"""

from __future__ import annotations

import logging
from datetime import datetime
from functools import partial, reduce
from operator import getitem
from pathlib import Path

from .logging import get_logger, setup_logging
from .util import read_json, write_json


class ConfigParser:
    def __init__(self, config, resume=None, modification=None, run_id=None,
                 make_dirs=True, device=None):
        """``device``: the torch device the entry points run on; None means
        the card (``enhance.resolve_device``)."""
        self._config = _update_config(config, modification)
        self.resume = resume
        self.device = device

        save_dir = Path(self.config["trainer"]["save_dir"])
        exper_name = self.config["name"]
        if run_id is None:
            run_id = datetime.now().strftime(r"%m%d_%H%M%S")
        self._save_dir = save_dir / exper_name / run_id
        self._log_dir = self._save_dir

        if make_dirs:
            self._save_dir.mkdir(parents=True, exist_ok=(run_id == ""))
            write_json(self.config, self._save_dir / "config.json")
            setup_logging(self._log_dir)

    @classmethod
    def from_args(cls, args, options=()):
        """Build from an ``argparse`` parser or its parsed namespace.

        ``options`` is a sequence of objects with ``flags``/``type``/``target``
        attributes; each becomes a flag writing to a ';'-separated config
        key path."""
        for opt in options:
            args.add_argument(*opt.flags, default=None, type=opt.type)
        if hasattr(args, "parse_args"):
            args = args.parse_args()

        device = getattr(args, "device", None)
        if not device or device.isdigit():
            device = None

        if getattr(args, "resume", None) is not None:
            resume = Path(args.resume)
            cfg_fname = resume.parent / "config.json"
        else:
            if getattr(args, "config", None) is None:
                raise SystemExit("Configuration file needs to be specified; add "
                                 "'-c config.json', for example.")
            resume = None
            cfg_fname = Path(args.config)

        config = read_json(cfg_fname)
        if getattr(args, "config", None) and resume:
            # fine-tuning: overlay the new config on the run-dir snapshot
            config.update(read_json(args.config))

        modification = {opt.target: getattr(args, _get_opt_name(opt.flags)) for opt in options}
        return cls(config, resume, modification, device=device)

    def init_obj(self, name, registry, *args, **kwargs):
        """``registry[config[name]['type']](*args, **config_args, **kwargs)``;
        a kwarg that the config's args also set is refused."""
        entry = self[name]
        ctor = _resolve(registry, entry["type"])
        obj_args = dict(entry.get("args", {}))
        overlap = [k for k in kwargs if k in obj_args]
        if overlap:
            raise ValueError(f"overwriting config kwargs not allowed: {overlap}")
        obj_args.update(kwargs)
        return ctor(*args, **obj_args)

    def init_ftn(self, name, registry, *args, **kwargs):
        """The ``functools.partial`` form of :meth:`init_obj`."""
        entry = self[name]
        fn = _resolve(registry, entry["type"])
        obj_args = dict(entry.get("args", {}))
        overlap = [k for k in kwargs if k in obj_args]
        if overlap:
            raise ValueError(f"overwriting config kwargs not allowed: {overlap}")
        obj_args.update(kwargs)
        return partial(fn, *args, **obj_args)

    def __getitem__(self, name):
        return self.config[name]

    def __contains__(self, name):
        return name in self.config

    def get(self, name, default=None):
        return self.config.get(name, default)

    def get_logger(self, name, verbosity=2) -> logging.Logger:
        return get_logger(name, verbosity)

    @property
    def config(self):
        return self._config

    @property
    def save_dir(self) -> Path:
        return self._save_dir

    @property
    def log_dir(self) -> Path:
        return self._log_dir


def _resolve(registry, type_name):
    if callable(registry) and not hasattr(registry, "__getitem__"):
        return registry  # already a constructor
    if hasattr(registry, "__getitem__"):
        try:
            return registry[type_name]
        except KeyError:
            pass
        raise KeyError(f"unknown type '{type_name}'; available: "
                       f"{sorted(registry) if hasattr(registry, 'keys') else registry}")
    return getattr(registry, type_name)


def _update_config(config, modification):
    if not modification:
        return config
    for k, v in modification.items():
        if v is not None:
            _set_by_path(config, k, v)
    return config


def _get_opt_name(flags):
    for flg in flags:
        if flg.startswith("--"):
            return flg.replace("--", "")
    return flags[0].replace("--", "")


def _set_by_path(tree, keys, value):
    keys = keys.split(";")
    _get_by_path(tree, keys[:-1])[keys[-1]] = value


def _get_by_path(tree, keys):
    return reduce(getitem, keys, tree)
