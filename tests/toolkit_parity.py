"""Helpers of the CARLA-toolkit parity tests (``tests/test_torch_*``):
run one case with the JAX package's modules and with the port's, on the
same inputs, and compare what each returned or wrote at tolerance 0.

A case is ``case(p, *args)`` where ``p`` is a :class:`Pkg`: ``p.sim`` is
``<package>.forking_paths.sim``, ``p.mod("cli.moment_tools")`` any other
module, ``p.fp`` the ``forking_paths`` package itself. :func:`both` runs
it for the two packages, with each package's fake ``carla`` installed
and its actor-id counter reset first where the case asks for one (the
fakes number actors from a module-global counter, so two runs in one
process would otherwise see different ids)."""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import os
import pickle
import sys

import numpy as np

from tests import fake_carla, torch_fake_carla
from tests.test_torch_prepare_data import _files as files
from tests.test_torch_prepare_data import _same as same

JAX, PORT = "multiverse_tpu", "multiverse_torch"
FAKES = {JAX: fake_carla, PORT: torch_fake_carla}


class Pkg:
    """Attribute access to one package's modules."""

    def __init__(self, name: str):
        self.name = name

    def __getattr__(self, module: str):
        if module.startswith("_"):
            raise AttributeError(module)
        return importlib.import_module(
            "%s.forking_paths.%s" % (self.name, module))

    def mod(self, path: str):
        return importlib.import_module("%s.%s" % (self.name, path))

    @property
    def fp(self):
        return importlib.import_module(self.name + ".forking_paths")

    @property
    def fake(self):
        return FAKES[self.name]


def install_fake(name: str):
    """Install the package's fake ``carla`` with its ids from 1."""
    fake = FAKES[name]
    fake._ids = itertools.count(1)
    return fake.install()


def plain(x):
    """``x`` with every dataclass as (class name, fields) and every set
    sorted, so values of the two packages' classes compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(x, key=repr))
    return x


def both(case, *args, carla: bool = False, tmp=None):
    """Run ``case`` with the JAX package and with the port; assert the
    two results equal (after :func:`plain`) and return the port's.
    ``carla``: install each package's fake first, ids reset. ``tmp``: a
    directory; each side gets its own ``tmp/jax`` or ``tmp/port`` as
    its first argument after ``p``."""
    outs = []
    for name in (JAX, PORT):
        extra = ()
        if tmp is not None:
            d = os.path.join(str(tmp), "jax" if name == JAX else "port")
            os.makedirs(d, exist_ok=True)
            extra = (d,)
        if carla:
            install_fake(name)
        try:
            outs.append(plain(case(Pkg(name), *extra, *args)))
        finally:
            if carla:
                sys.modules.pop("carla", None)
    same(outs[1], outs[0], case.__name__)
    return outs[1]


def video_frames(path: str) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0,), np.uint8)


def same_tree(got: str, want: str, skip=()) -> int:
    """Every file of ``want`` in ``got`` and no other: ``.mp4`` videos
    by their decoded frames (array-equal), pickles and ``.npy`` equal
    after loading with equal types, every other file byte-equal, but
    the names in ``skip`` (compared by the caller). Returns the number
    of files."""
    names = files(want)
    assert files(got) == names
    for name in names:
        if name in skip:
            continue
        a, b = os.path.join(got, name), os.path.join(want, name)
        if name.endswith(".mp4"):
            fa, fb = video_frames(a), video_frames(b)
            assert fa.shape == fb.shape and fa.size, name
            assert np.array_equal(fa, fb), name
        elif name.endswith(".p"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same(pickle.load(fa), pickle.load(fb), name)
        elif name.endswith(".npy"):
            same(np.load(a), np.load(b), name)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    return len(names)
