"""JSON read and write (counterpart of ``sddm_tpu/utils/util.py``; its
training helpers wait for the training slice)."""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path


def read_json(fname):
    with Path(fname).open("rt") as handle:
        return json.load(handle, object_hook=OrderedDict)


def write_json(content, fname):
    with Path(fname).open("wt") as handle:
        json.dump(content, handle, indent=4, sort_keys=False)
