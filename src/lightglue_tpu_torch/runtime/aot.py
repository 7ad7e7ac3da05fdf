"""Ahead-of-time export of the session's steps, and the kernel-library cache.

Counterpart of ``lightglue_tpu/runtime/aot.py``. The reference deploys
ONNX -> ``trtexec`` -> a serialized ``.engine`` reloaded at start-up, with
its ``MHAHeadDim64`` plugin library loaded first. Here:

- ``export_matcher`` / ``export_extractor``: ``torch.export`` of the
  session's per-bucket match step and of the extraction step (the ONNX
  analog): a self-contained graph, saved with ``torch.export.save``, that
  takes the weights as its first input. The graph names the hand-written
  kernels as operators of the ``lightglue_tpu_torch`` namespace
  (``kernels/_build.py:define_op``).
- ``load_exported``: ``torch.export.load`` in a process that need not have
  run the model code. Importing this module registers every operator (the
  plugin analog: it must be loaded before an engine) and the output types.
- ``enable_compile_cache``: the built kernel library is the engine analog;
  a process that finds it in the cache directory loads it without ``nvcc``.

An artifact holds the device it was exported on: export on the device you
serve on. A CPU artifact names the same operators, and on the CPU they run
their plain versions. The precision rung and ``LGTPU_W8A8`` are read while
the step is traced, and the artifact keeps them; the FP32 rung's TF32 switch
is a process setting, so the artifact records the rung and the loaded
callable sets it around each call.
"""

from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

# importing the kernel modules defines every operator an artifact may name
from lightglue_tpu_torch.kernels import (  # noqa: F401
    _build, attention, conv, conv_chain, layer_stack, nms, stem)
from lightglue_tpu_torch.models.lightglue import AdaptiveOutput, LightGlueOutput
from lightglue_tpu_torch.pipeline.extract import Extraction
from lightglue_tpu_torch.pipeline.match import Matches
from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope
from lightglue_tpu_torch.runtime import session as session_lib

for _nt in (LightGlueOutput, AdaptiveOutput, Extraction, Matches):
    try:
        pytree._register_namedtuple(_nt, serialized_type_name=f"lightglue_tpu_torch.{_nt.__name__}")
    except ValueError:
        pass  # already registered (repeated import)

_META = "lightglue_tpu_torch.json"  # the artifact's extra file: the rung it was traced at
# a split match step (the downshift's host read): one program per part
_HEAD, _REST = "head.pt2", {True: "rest_fits.pt2", False: "rest_full.pt2"}


def enable_compile_cache(cache_dir: str) -> None:
    """Cache the kernel library in ``cache_dir`` (created if missing): a
    process that finds it there loads it without running ``nvcc``. Raises
    where the directory cannot be written, or where this process already
    loaded the library from another directory.

    The setting is per process, as the library is: until the library loads,
    the last call (or ``MatcherSession(compile_cache_dir=...)``) wins; once
    it has loaded, only its own directory is accepted."""
    path = Path(cache_dir).expanduser().resolve()
    with _build._lib_lock:
        if _build._lib is not None and _build._lib_dir != path:
            raise RuntimeError(f"the kernel library is already loaded from {_build._lib_dir}; "
                               f"cannot cache it in {path}")
        path.mkdir(parents=True, exist_ok=True)
        if not os.access(path, os.W_OK | os.X_OK):
            raise PermissionError(f"kernel cache directory {path} is not writable")
        _build.BUILD_DIR = path


class _Step(torch.nn.Module):
    """A function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn: Callable, args: tuple, path: Path, precision: Precision) -> None:
    program = torch.export.export(_Step(fn), args, strict=False)
    program.example_inputs = None  # they hold the weights: the artifact keeps only the graph
    torch.export.save(program, str(path),
                      extra_files={_META: json.dumps({"precision": precision.value})})


def _zeros_like_outputs(fn: Callable, args: tuple):
    """``fn``'s outputs on ``args`` as zeros of the same shapes, dtypes and
    devices, traced on fake tensors: no kernel runs."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args)
    return pytree.tree_map_only(
        torch.Tensor, lambda t: torch.zeros(t.shape, dtype=t.dtype, device=t.device), out)


def _match_inputs(session, batch: int, b0: int, b1: int) -> tuple:
    dim, dev = session.config.lightglue.input_dim, session.device
    return (torch.zeros((batch, b0, 2), device=dev), torch.zeros((batch, b1, 2), device=dev),
            torch.zeros((batch, b0, dim), device=dev), torch.zeros((batch, b1, dim), device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


def export_matcher(session, out_dir: str, batch: int = 1,
                   pairs=None) -> Dict[Tuple[int, int], str]:
    """Export the session's match step per bucket pair (JAX :47-93).

    ``pairs``: iterable of (bucket0, bucket1); None is the ladder diagonal,
    "all" every combination. A program takes ``(lg_params, kpts0, kpts1,
    desc0, desc1, count0, count1)`` at ``batch`` pairs and returns the
    session body's ``(LightGlueOutput | AdaptiveOutput, Matches)``; the
    weights stay an argument, so one artifact serves any checkpoint of the
    same shapes. Where the step makes the downshift's host read
    (``session.reads_host``), the artifact is a directory of three
    programs: the head up to the read and the rest for each value read.

    Returns {(bucket0, bucket1): path}.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buckets = session.config.buckets
    if pairs is None:
        pairs = [(b, b) for b in buckets]
    elif pairs == "all":
        pairs = [(b0, b1) for b0 in buckets for b1 in buckets]
    config, policy, params = session.config, session.policy, session.lg_params
    bound = dict(config=config, policy=policy)
    paths = {}
    for b0, b1 in pairs:
        args = (params, *_match_inputs(session, batch, b0, b1))
        head = functools.partial(session_lib.match_head, full=False, **bound)
        path = out / f"match_{b0}x{b1}_b{batch}"
        if session_lib.reads_host(params, b0, b1, config, policy):
            # the head's state crosses between the programs as its tensors;
            # its ints (the buckets) are constants of the rest
            state = _zeros_like_outputs(head, args)
            ints = {k: v for k, v in state.items() if not isinstance(v, torch.Tensor)}

            def head_tensors(*a):
                return {k: v for k, v in head(*a).items() if k not in ints}

            path.mkdir(exist_ok=True)
            _export(head_tensors, args, path / _HEAD, config.precision)
            for fits, name in _REST.items():
                def rest(lg_params, tensors, fits=fits):
                    return session_lib.match_rest(lg_params, {**tensors, **ints}, fits, **bound)

                _export(rest, (params, {k: v for k, v in state.items() if k not in ints}),
                        path / name, config.precision)
        else:
            def step(lg_params, *inputs):
                return session_lib.match_rest(lg_params, head(lg_params, *inputs), None, **bound)

            path = path.with_suffix(".pt2")
            _export(step, args, path, config.precision)
        paths[(b0, b1)] = str(path)
    return paths


def export_extractor(session, out_dir: str, image_hw: Tuple[int, int], batch: int = 1) -> str:
    """Export the session's extraction step (SuperPoint and keypoint
    selection, the superpoint.engine analog; JAX :96-109) for (batch, H, W,
    1) fp32 images: a program of ``(sp_params, images)`` that returns the
    ``Extraction``. Returns the artifact's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    h, w = image_hw
    body = functools.partial(session_lib.extract_body, config=session.config,
                             policy=session.policy)
    images = torch.zeros((batch, h, w, 1), device=session.device)
    path = out / f"extract_{h}x{w}_b{batch}.pt2"
    _export(body, (session.sp_params, images), path, session.config.precision)
    return str(path)


def _load(path: Path) -> Callable:
    meta = {_META: ""}
    program = torch.export.load(str(path), extra_files=meta)
    policy = policy_for(json.loads(meta[_META])["precision"])
    module = program.module()

    def call(*args):
        with torch.inference_mode(), precision_scope(policy):
            return module(*args)

    return call


def load_exported(path: str) -> Callable:
    """The artifact at ``path`` as a callable of the same arguments as the
    function exported (JAX :112-117). A split match step runs its head,
    reads the flag on the host once, then the rest for the value read."""
    path = Path(path)
    if not path.is_dir():
        return _load(path)
    head = _load(path / _HEAD)
    rests = {fits: _load(path / name) for fits, name in _REST.items()}

    def run(lg_params, *inputs):
        state = head(lg_params, *inputs)
        return rests[bool(state["fits"])](lg_params, state)

    return run

