"""The port's ``ConfigParser`` against the JAX package's, on the cases of
tests/test_config.py: the run dir and its snapshot, key-path modification,
a ``None`` modification ignored, ``init_obj`` and ``init_ftn`` over a
registry, a kwarg conflict, a missing ``-c``, and resume merging the run's
config.  Each case runs through both parsers; the results must be equal.
The port's ``-d`` records the torch device (bare GPU indices ignored)."""

import argparse
import json
from pathlib import Path

import pytest

from sddm_tpu.utils import ConfigParser as JaxConfigParser
from sddm_tpu_torch.utils import ConfigParser
from sddm_tpu_torch.utils.config import _set_by_path

PARSERS = {"jax": JaxConfigParser, "torch": ConfigParser}


def base_config(root, name="cfgtest"):
    return {
        "name": name,
        "arch": {"type": "SDDM", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.002}},
        "trainer": {"save_dir": str(root / "saved"), "verbosity": 1},
    }


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", default=None)
    parser.add_argument("-r", "--resume", default=None)
    parser.add_argument("-d", "--device", default=None)
    return parser


def _run_dir(cls, root):
    cfg = cls(base_config(root), run_id="rid")
    snap = json.loads((cfg.save_dir / "config.json").read_text())
    return cfg.save_dir, snap


def _keypath(cls, root):
    return cls(base_config(root), modification={"optimizer;args;lr": 0.1},
               run_id="rid").config


def _none_ignored(cls, root):
    return cls(base_config(root), modification={"optimizer;args;lr": None},
               run_id="rid").config


def _init_obj(cls, root):
    return cls(base_config(root), run_id="rid").init_obj("optimizer",
                                                         {"Adam": lambda lr: ("adam", lr)})


def _init_obj_conflict(cls, root):
    with pytest.raises(ValueError) as err:
        cls(base_config(root), run_id="rid").init_obj("optimizer", {"Adam": lambda lr: lr}, lr=5)
    return str(err.value)


def _init_ftn(cls, root):
    fn = cls(base_config(root), run_id="rid").init_ftn("optimizer",
                                                       {"Adam": lambda x, lr: (x, lr)})
    return fn(7)


def _unknown_type(cls, root):
    with pytest.raises(KeyError) as err:
        cls(base_config(root), run_id="rid").init_obj("optimizer", {"SGD": dict})
    return str(err.value)


def _requires_config(cls, root):
    with pytest.raises(SystemExit) as err:
        cls.from_args(_parser().parse_args([]))
    return str(err.value)


def _resume_merges(cls, root):
    first = cls(base_config(root), run_id="orig")
    ckpt = first.save_dir / "checkpoint_current.ckpt"
    ckpt.write_bytes(b"")
    ft = dict(base_config(root))
    ft["optimizer"] = {"type": "Adam", "args": {"lr": 9.0}}
    ft_path = root / "ft.json"
    ft_path.write_text(json.dumps(ft))
    cfg = cls.from_args(_parser().parse_args(["-r", str(ckpt), "-c", str(ft_path)]))
    return cfg.resume, cfg.config


def _resume_alone(cls, root):
    first = cls(base_config(root, "alone"), run_id="orig")
    ckpt = first.save_dir / "model_best.ckpt"
    ckpt.write_bytes(b"")
    cfg = cls.from_args(_parser().parse_args(["-r", str(ckpt), "-d", "0"]))
    return cfg.resume, cfg.config, cfg.save_dir.parent


CASES = {
    "run_dir_and_snapshot": _run_dir,
    "keypath_modification": _keypath,
    "none_modification_ignored": _none_ignored,
    "init_obj_registry": _init_obj,
    "init_obj_kwarg_conflict": _init_obj_conflict,
    "init_ftn": _init_ftn,
    "init_obj_unknown_type": _unknown_type,
    "from_args_requires_config": _requires_config,
    "from_args_resume_merges_run_config": _resume_merges,
    "from_args_resume_reads_run_config": _resume_alone,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_result_as_jax(case, tmp_path, monkeypatch):
    """Each parser runs in a directory of its own, with relative paths, so
    that the two results can be compared whole."""
    got = {}
    for name, cls in PARSERS.items():
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        got[name] = CASES[case](cls, Path("."))
    assert got["torch"] == got["jax"]


def test_options_write_their_key_paths(tmp_path, monkeypatch):
    """``from_args`` with options: each flag writes its ';'-separated path."""
    from sddm_tpu.cli import DEFAULT_OPTIONS

    out = {}
    for name, cls in PARSERS.items():
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(base_config(Path("."))))
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        monkeypatch.setattr("sys.argv", ["prog", "-c", str(cfg_path), "--lr", "0.5"])
        out[name] = cls.from_args(_parser(), DEFAULT_OPTIONS).config
    assert out["torch"] == out["jax"]
    assert out["torch"]["optimizer"]["args"]["lr"] == 0.5


@pytest.mark.parametrize("flag,device", [(None, None), ("cpu", "cpu"), ("0", None),
                                         ("cuda:1", "cuda:1")])
def test_device_flag_is_recorded(flag, device, tmp_path):
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps(base_config(tmp_path)))
    argv = ["-c", str(cfg_path)] + (["-d", flag] if flag else [])
    assert ConfigParser.from_args(_parser().parse_args(argv)).device == device


def test_set_by_path():
    tree = {"a": {"b": {"c": 1}}}
    _set_by_path(tree, "a;b;c", 5)
    assert tree["a"]["b"]["c"] == 5
