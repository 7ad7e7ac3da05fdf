"""The port's kernel wrappers as ``torch.library`` operators of the
``lightglue_tpu_torch`` namespace (``kernels/_build.py:define_op``), on the
CPU: ``torch.library.opcheck`` on every operator with the test utilities
that apply to operators without autograd; each operator's CPU call against
its plain version, bit for bit; each fake implementation's shapes and
dtypes against the real call's (``live``, the W8A8 projection and
``adaptive_decide``'s in-place updates included); and an export trace,
which records the operators and moves no launch counter. The JAX package has
no such layer: what the operators compute is held against JAX by the
kernel modules' own tests, and the exported programs by test_torch_aot.py."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.kernels import _build, attention, conv, conv_chain
from lightglue_tpu_torch.kernels import layer_stack as ls
from lightglue_tpu_torch.kernels import nms, stem
from lightglue_tpu_torch.quant import quantize_lightglue
from lightglue_tpu_torch.runtime import weights

OPS = torch.ops.lightglue_tpu_torch
F32, BF16, I8, I32 = torch.float32, torch.bfloat16, torch.int8, torch.int32
# opcheck's utilities for an operator without autograd: schema, fake
# implementation, and the operator traced by AOTAutograd at dynamic shapes
OPCHECK_UTILS = ("test_schema", "test_faketensor", "test_aot_dispatch_dynamic")
E, H, N = 128, 2, 64  # feature width, heads (64 wide), rows


def _rand(gen, *shape, dtype=F32, scale=1.0):
    return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _freqs(gen, b, n):
    ang = torch.from_numpy(gen.uniform(-3, 3, (b, n, 32)).astype(np.float32))
    emb = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    return torch.cat([emb, emb], dim=-1)


def _int8(gen, k, n):
    w = torch.from_numpy(gen.integers(-127, 128, (k, n)).astype(np.int8))
    return w, torch.from_numpy(gen.uniform(0.001, 0.01, n).astype(np.float32))


def _lin(*, a, w, b, a2=None, residual=None, exit=None, layer=0, scale=None, out_dtype=None,
         w8a8=False, w_t=None):
    return (a, w, b, a2, residual, exit, layer, scale, out_dtype, w8a8, w_t)


def _attn(q, k, v, freqs=None, len_q=None, len_kv=None, stat=F32, out_dtype=None, keep_q=None,
          keep_kv=None, exit=None, layer=0, dir1=False):
    return (q, k, v, freqs, len_q, len_kv, H, stat, out_dtype, keep_q, keep_kv, exit, layer, dir1)


def _decide(x0, x1, w_tok, b_tok, exit, layer, lengths=(None, None), match=(None, None),
            width=-1.0, keep=(None, None)):
    return (x0, x1, w_tok, b_tok, exit, layer, 4, 0.5, *lengths, *match, width, *keep)


def _cases():
    """name -> (operator, its positional arguments): every operator, and
    the modes and operands the port's paths give it."""
    g = np.random.default_rng(7)
    qkv = _rand(g, 2, N, 3 * E)
    qk_v0, qk_v1 = _rand(g, 2, N, 2 * E), _rand(g, 2, 48, 2 * E)
    lens, exit = torch.tensor([N - 7, 40], dtype=I32), torch.tensor([5.0, 1.0])
    keep = (torch.from_numpy((g.random((2, N)) > 0.3).astype(np.float32)),
            torch.from_numpy((g.random((2, 48)) > 0.3).astype(np.float32)))
    w8, sc8 = _int8(g, 2 * E, E)
    a16 = _rand(g, 2, N, E, dtype=BF16)
    cases = {
        "stem fp32": (OPS.relu_conv1a_shift, (_rand(g, 1, 16, 24, 1), _rand(g, 3, 3, 1, 64),
                                              _rand(g, 64))),
        "stem bf16": (OPS.relu_conv1a_shift, (_rand(g, 2, 8, 16, 1, dtype=BF16),
                                              _rand(g, 3, 3, 1, 64), _rand(g, 64))),
        "conv3x3 bf16 pool": (OPS.conv3x3, (_rand(g, 1, 8, 12, 16, dtype=BF16),
                                            _rand(g, 3, 3, 16, 32, dtype=BF16, scale=0.2),
                                            _rand(g, 32), True, True, None)),
        "conv3x3 fp32 no relu, bf16 out": (OPS.conv3x3, (
            _rand(g, 2, 8, 8, 24), _rand(g, 3, 3, 24, 40, scale=0.2), _rand(g, 40), False,
            False, BF16)),
        "conv2_chain": (OPS.conv2_chain, (_rand(g, 1, 8, 12, 64), _rand(g, 3, 3, 64, 64, scale=0.1),
                                          _rand(g, 64), _rand(g, 3, 3, 64, 64, scale=0.1),
                                          _rand(g, 64), True, None)),
        "nms_candidates": (OPS.nms_candidates, (torch.rand(2, 24, 32, generator=torch.Generator()
                                                           .manual_seed(3)), 4, 4, 4)),
        "row_quant": (OPS.row_quant, (a16, _rand(g, 2, N, E, dtype=BF16))),
        "linear fp32": (OPS.linear, _lin(a=_rand(g, 2, N, E), w=_rand(g, E, E, scale=0.1),
                                         b=_rand(g, E))),
        "linear bf16 a2 residual": (OPS.linear, _lin(
            a=a16, a2=_rand(g, 2, N, E, dtype=BF16), w=_rand(g, 2 * E, E, dtype=BF16, scale=0.1),
            b=_rand(g, E, dtype=BF16), residual=_rand(g, 2, N, E, dtype=BF16))),
        "linear MIXED bf16 out": (OPS.linear, _lin(a=_rand(g, 2, N, E),
                                                   w=_rand(g, E, 2 * E, dtype=BF16, scale=0.1),
                                                   b=_rand(g, 2 * E), out_dtype=BF16)),
        "linear INT8": (OPS.linear, _lin(a=a16, a2=a16, w=w8, b=_rand(g, E), scale=sc8)),
        "linear W8A8 live residual": (OPS.linear, _lin(
            a=a16, a2=_rand(g, 2, N, E, dtype=BF16), w=w8, b=_rand(g, E), scale=sc8,
            residual=_rand(g, 2, N, E, dtype=BF16), exit=exit, layer=2, w8a8=True,
            w_t=w8.t().contiguous())),
        "attention self RoPE masked": (OPS.attention, _attn(
            qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:], _freqs(g, 2, N), lens, lens)),
        "attention cross dir1 bf16 stats": (OPS.attention, _attn(
            qk_v1[..., :E], qk_v0[..., :E], qk_v0[..., E:], None, torch.tensor([40, 3], dtype=I32),
            lens, stat=BF16, dir1=True)),
        "attention keep masks live": (OPS.attention, _attn(
            qk_v0[..., :E], qk_v1[..., :E], qk_v1[..., E:], keep_q=keep[0], keep_kv=keep[1],
            exit=exit, layer=2)),
        "ln_gelu fp32": (OPS.ln_gelu, (_rand(g, 2, N, 96), _rand(g, 96), _rand(g, 96), None, 0)),
        "ln_gelu bf16, fp32 gamma beta, live": (OPS.ln_gelu, (
            _rand(g, 2, N, 96, dtype=BF16), _rand(g, 96), _rand(g, 96), exit, 3)),
        "adaptive_decide depth masked": (OPS.adaptive_decide, _decide(
            # a confident token head: the live pair stops, the retired one stays
            qk_v0[..., :E].contiguous(), qk_v1[..., :E].contiguous(), _rand(g, E, scale=0.1),
            torch.tensor([5.0]), torch.tensor([9.0, 1.0]), 1,
            lengths=(lens, torch.tensor([40, 9], dtype=I32)))),
        "adaptive_decide width": (OPS.adaptive_decide, _decide(
            # few confident tokens, none matchable: no pair stops, the confident prune
            qk_v0[..., :E].contiguous(), qk_v1[..., :E].contiguous(), _rand(g, E, scale=0.1),
            torch.zeros(1), torch.tensor([9.0, 9.0]), 2,
            match=(_rand(g, E, scale=0.1), torch.tensor([-5.0])), width=0.9, keep=keep)),
        "fused_mha RoPE masked bf16 stats": (OPS.fused_mha, (
            qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:], _freqs(g, 2, N),
            torch.stack([lens, lens], dim=-1), H, None, BF16, None, 1024, 32)),
        "flash_attention": (OPS.flash_attention, (
            _rand(g, 1, H, N, 64), _rand(g, 1, H, 96, 64), _rand(g, 1, H, 96, 64),
            torch.tensor([[50, 70]], dtype=I32), 0.1, F32, None, 1024, 32)),
        "flash_attention_step": (OPS.flash_attention_step, (
            _rand(g, 1, H, 32, 64), _rand(g, 1, H, 32, 64), _rand(g, 1, H, 32, 64),
            _rand(g, 1, H, 32, 1), torch.rand(1, H, 32, 1) + 1, _rand(g, 1, H, 32, 64),
            torch.tensor([[60, 40]], dtype=I32), 32, 32, None, F32, 16, 16)),
        "bidirectional_cross_attention": (OPS.bidirectional_cross_attention, (
            qk_v0[..., :E], qk_v1[..., :E], qk_v0[..., E:], qk_v1[..., E:],
            torch.tensor([[N, 40], [20, 48]], dtype=I32), H, None, F32, None)),
    }
    return {name: (op.default, args) for name, (op, args) in cases.items()}


CASES = _cases()
PLAIN = {
    "relu_conv1a_shift": stem.relu_conv1a_shift_plain,
    "conv3x3": lambda x, w, b, pool, relu, out: conv.conv3x3_plain(x, w, b, pool, relu=relu,
                                                                   out_dtype=out),
    "conv2_chain": lambda x, wa, ba, wb, bb, relu, out: conv_chain.conv2_chain_plain(
        x, wa, ba, wb, bb, relu=relu, out_dtype=out),
    "nms_candidates": nms.nms_candidates_plain,
    "row_quant": ls.row_quant_plain,
    "linear": lambda a, w, b, a2, res, exit, layer, scale, out, w8a8, w_t: ls.linear_plain(
        a, w, b, a2, res, None if exit is None else ls.Live(exit, layer), scale=scale,
        out_dtype=out, w8a8=w8a8, w_t=w_t),
    "attention": lambda *a: ls.attention_plain(*a[:11], None if a[11] is None else ls.Live(
        a[11], a[12]), a[13]),
    "ln_gelu": lambda h, g, b, exit, layer: ls.ln_gelu_plain(
        h, g, b, None if exit is None else ls.Live(exit, layer)),
    "adaptive_decide": lambda x0, x1, wt, bt, exit, layer, n, dc, l0, l1, wm, bm, wc, k0, k1:
        ls.adaptive_decide_plain(x0, x1, wt, bt, exit, layer=layer, n_layers=n,
                                 depth_confidence=dc, lengths0=l0, lengths1=l1, w_match=wm,
                                 b_match=bm, width_confidence=wc, keep0=k0, keep1=k1),
    "fused_mha": lambda q, k, v, f, lens, h, s, st, out, bq, bk: attention.fused_mha_plain(
        q, k, v, f, lens, num_heads=h, scale=s, stat_dtype=st, out_dtype=out, block_q=bq,
        block_k=bk),
    "flash_attention": lambda q, k, v, lens, s, st, out, bq, bk: attention.flash_attention_plain(
        q, k, v, lens, scale=s, stat_dtype=st, out_dtype=out, block_q=bq, block_k=bk),
    "flash_attention_step": lambda q, k, v, m, l, acc, lens, r0, c0, s, st, bq, bk:
        attention.flash_attention_step_plain(q, k, v, m, l, acc, lens, r0, c0, scale=s,
                                             stat_dtype=st, block_q=bq, block_k=bk),
    "bidirectional_cross_attention": lambda q0, q1, v0, v1, lens, h, s, st, out:
        attention.bidirectional_cross_attention_plain(q0, q1, v0, v1, lens, num_heads=h,
                                                      scale=s, stat_dtype=st, out_dtype=out),
}
# every wrapper of the port, by its operator's name: each has a case above
WRAPPERS = {fn.__name__: fn for fn in (
    stem.relu_conv1a_shift, conv.conv3x3, conv_chain.conv2_chain, nms.nms_candidates,
    ls.row_quant, ls.linear, ls.attention, ls.ln_gelu, ls.adaptive_decide, attention.fused_mha,
    attention.flash_attention, attention.flash_attention_step,
    attention.bidirectional_cross_attention)}


def _name(op) -> str:
    return op._schema.name.split("::")[1]


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def _mutated(op, args):
    """The arguments ``op`` writes (its schema's ``(a!)`` annotations)."""
    return [a for a, s in zip(args, op._schema.arguments)
            if s.alias_info is not None and s.alias_info.is_write and a is not None]


def _outputs(op, args):
    """What a call gives: its returned tensors, else the arguments it wrote."""
    out = op(*args)
    if out is None:
        return _mutated(op, args)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.reshape(-1).view(torch.uint8).equal(b.reshape(-1).view(torch.uint8)))


def test_every_wrapper_is_an_operator_with_a_case():
    assert set(WRAPPERS) == {_name(op) for op, _ in CASES.values()} == set(PLAIN)
    for name in WRAPPERS:
        op = getattr(OPS, name).default
        assert op._schema.name == f"{_build.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)


@pytest.mark.parametrize("case", list(CASES))
def test_opcheck(case):
    op, args = CASES[case]
    torch.library.opcheck(op, _clone(args), test_utils=OPCHECK_UTILS)


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_call_is_the_plain_version_bit_for_bit(case):
    op, args = CASES[case]
    got_args, want_args = _clone(args), _clone(args)
    got = _outputs(op, got_args)
    want = PLAIN[_name(op)](*want_args)
    if want is None:  # an in-place operator: the arguments it wrote
        want = _mutated(op, want_args)
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same_bits(g, w), case
    # the wrapper on CPU tensors outside a trace runs the same plain version
    wrapped = _wrapper_call(_name(op), _clone(args))
    wrapped = list(wrapped) if isinstance(wrapped, (tuple, list)) else [wrapped]
    assert len(wrapped) == len(want) and all(_same_bits(g, w) for g, w in zip(wrapped, want))


def _wrapper_call(name, args):
    """The public wrapper on an operator case's positional arguments: what it
    returns, or for ``adaptive_decide`` the arguments it wrote."""
    if name == "adaptive_decide":
        x0, x1, wt, bt, exit, layer, n, dc, l0, l1, wm, bm, wc, k0, k1 = args
        ls.adaptive_decide(x0, x1, wt, bt, exit, layer=layer, n_layers=n, depth_confidence=dc,
                           lengths0=l0, lengths1=l1, w_match=wm, b_match=bm,
                           width_confidence=wc, keep0=k0, keep1=k1)
        return _mutated(OPS.adaptive_decide.default, args)
    if name == "linear":
        a, w, b, a2, res, exit, layer, scale, out, w8a8, w_t = args
        return ls.linear(a, w, b, a2, res, None if exit is None else ls.Live(exit, layer),
                         scale=scale, out_dtype=out, w8a8=w8a8, w_t=w_t)
    if name == "attention":
        live = None if args[11] is None else ls.Live(args[11], args[12])
        return ls.attention(*args[:11], live=live, dir1=args[13])
    if name == "ln_gelu":
        return ls.ln_gelu(*args[:3], None if args[3] is None else ls.Live(args[3], args[4]))
    if name == "conv3x3":
        return conv.conv3x3(*args[:4], relu=args[4], out_dtype=args[5])
    if name == "conv2_chain":
        return conv_chain.conv2_chain(*args[:5], relu=args[5], out_dtype=args[6])
    if name == "fused_mha":
        q, k, v, f, lens, h, s, st, out, bq, bk = args
        return attention.fused_mha(q, k, v, f, lens, num_heads=h, scale=s, stat_dtype=st,
                                   out_dtype=out, block_q=bq, block_k=bk)
    if name == "flash_attention":
        q, k, v, lens, s, st, out, bq, bk = args
        return attention.flash_attention(q, k, v, lens, scale=s, stat_dtype=st, out_dtype=out,
                                         block_q=bq, block_k=bk)
    if name == "flash_attention_step":
        *t, s, st, bq, bk = args
        return attention.flash_attention_step(*t, scale=s, stat_dtype=st, block_q=bq, block_k=bk)
    if name == "bidirectional_cross_attention":
        *t, h, s, st, out = args
        return attention.bidirectional_cross_attention(*t, num_heads=h, scale=s, stat_dtype=st,
                                                       out_dtype=out)
    return WRAPPERS[name](*args)


@pytest.mark.parametrize("case", list(CASES))
def test_fake_shapes_and_dtypes_equal_the_real_call(case):
    op, args = CASES[case]
    real = _outputs(op, _clone(args))
    with FakeTensorMode() as mode:
        fake_args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                          for a in args)
        fake = _outputs(op, fake_args)
    assert [(t.shape, t.dtype, t.device) for t in fake] == [
        (t.shape, t.dtype, t.device) for t in real]


def test_adaptive_decide_declares_its_in_place_updates():
    writes = [a.name for a in OPS.adaptive_decide.default._schema.arguments
              if a.alias_info is not None and a.alias_info.is_write]
    assert writes == ["exit", "keep0", "keep1"]
    # no other operator writes an argument
    for name in WRAPPERS:
        if name != "adaptive_decide":
            assert not any(a.alias_info is not None and a.alias_info.is_write
                           for a in getattr(OPS, name).default._schema.arguments), name
    op, args = CASES["adaptive_decide width"]
    before = _clone(args)
    op(*args)
    changed = [i for i, (a, b) in enumerate(zip(args, before))
               if isinstance(a, torch.Tensor) and not torch.equal(a, b)]
    assert changed == [13, 14]  # the keep masks: tokens pruned, no pair stopped
    op, args = CASES["adaptive_decide depth masked"]
    exit = args[4].clone()
    op(*args[:4], exit, *args[5:])
    assert exit.tolist() == [2.0, 1.0]  # the live pair exits after layer 1


def _int8_stack(n_layers=1):
    tree = weights.init_lightglue(0, LightGlueConfig(n_layers=n_layers))
    return weights.params_from_numpy(quantize_lightglue(tree), "cpu")["layers"]


class _Stack(torch.nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = layers

    def forward(self, d0, d1, f0, f1, l0, l1):
        return ls.transformer_stack(self.layers, d0, d1, f0, f1, l0, l1, num_heads=4,
                                    head_dim=64, stat_dtype=BF16, attn_dtype=BF16)


@pytest.mark.parametrize("w8a8", ["0", "1"])
def test_int8_stack_export_records_w8a8_and_its_shapes(monkeypatch, w8a8):
    """LGTPU_W8A8 is read while the stack is traced: the exported linear
    calls carry it, and the fake outputs have the real call's shapes."""
    monkeypatch.setenv("LGTPU_W8A8", w8a8)
    g = np.random.default_rng(2)
    args = (_rand(g, 1, 64, 256, dtype=BF16), _rand(g, 1, 64, 256, dtype=BF16),
            _freqs(g, 1, 64), _freqs(g, 1, 64), torch.tensor([50], dtype=I32),
            torch.tensor([64], dtype=I32))
    stack = _Stack(_int8_stack())
    program = torch.export.export(stack, args, strict=False)
    flags = {n.args[9] for n in program.graph.nodes if n.target == OPS.linear.default}
    assert flags == {w8a8 == "1"}
    real = stack(*args)
    fake = [a.meta["val"] for n in program.graph.nodes if n.op == "output" for a in n.args[0]]
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]
    assert all(_same_bits(a, b) for a, b in zip(program.module()(*args), real))


def test_export_trace_launches_nothing():
    """An export trace records the operators; no wrapper's count moves (on
    the card the same trace runs only the fake implementations)."""
    for i, fn in enumerate(WRAPPERS.values()):
        fn.launches = 100 + i
    try:
        g = np.random.default_rng(3)
        args = (_rand(g, 1, 128, 256), _rand(g, 1, 128, 256), _freqs(g, 1, 128),
                _freqs(g, 1, 128), None, None)
        tree = weights.init_lightglue(0, LightGlueConfig(n_layers=1))
        layers = weights.params_from_numpy(tree, "cpu")["layers"]

        class Stack(torch.nn.Module):
            def forward(self, d0, d1, f0, f1):
                return ls.transformer_stack(layers, d0, d1, f0, f1, None, None, num_heads=4,
                                            head_dim=64)

        program = torch.export.export(Stack(), args[:4], strict=False)
        named = {_name(n.target) for n in program.graph.nodes
                 if isinstance(n.target, torch._ops.OpOverload)
                 and n.target.namespace == _build.NAMESPACE}
        assert named == {"linear", "attention", "ln_gelu"}
        assert [fn.launches for fn in WRAPPERS.values()] == [100 + i for i in range(len(WRAPPERS))]
    finally:
        for fn in WRAPPERS.values():
            fn.launches = 0
