"""Decode attention (B5, ``kernels/decode_attention``) on the CPU.

* The plain version (``ref.decode_attention``, the port's decode arithmetic
  before B5) against the JAX package's ``_decode_attention`` and the port's
  ``_attention_full`` in float32, at groups 1, 2, 4 and 5 and head widths
  16, 128 and 256, with and without a window: ragged per-row positions, one
  row at position 0, rows below and above the window's length, and cache
  entries past each row's position filled with noise that must not leak.
* A plain-torch model of the kernel's algorithm (its split of the visible
  positions and the merge of partial (max, sum, accumulator) triples)
  against the plain version, at every split the plan can give.
* The binding's rules: what raises before any launch, the split plan as a
  pure function of the shape, the shared-memory estimate against the
  source's formula and the budget; the op's route (CPU to the plain
  version) and the model's (a ``DTensor`` cache keeps the two matmuls).

The kernel itself runs only on the card:
``tests/test_torch_decode_attention_card.py``.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.models import transformer as TT

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
# float32 against float32: the same sums in another order
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, s, hkv, g, d, pos, seed=0, dtype=torch.float32):
    """q (B, 1, Hq, D), ck, cv (B, S, Hkv, D) from numpy, every cache entry
    filled (past each row's position too), and pos (B,) int32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    ck = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.asarray(pos, dtype=np.int32)
    return (*(torch.from_numpy(a).to(dtype) for a in (q, ck, cv)),
            torch.from_numpy(pos))


# (g, d, window, S, pos by row): groups 1, 2, 4, 5; D 16, 128, 256; rows
# at 0, inside the window, at its edge and past it, and at the cache's end
CASES = [
    (1, 16, None, 40, [0, 7, 39, 20]),
    (2, 16, 8, 40, [0, 5, 8, 9, 39]),
    (4, 128, None, 24, [23, 0, 11]),
    (4, 128, 6, 24, [3, 6, 7, 23]),
    (5, 128, None, 17, [16, 1]),
    (5, 128, 4, 17, [0, 4, 5, 16]),
    (1, 256, 10, 33, [32, 9, 10, 11, 0]),
    (2, 256, None, 33, [0, 32, 12]),
]
IDS = [f"g{g}-d{d}-w{w}" for g, d, w, *_ in CASES]


@pytest.mark.parametrize("g, d, window, s, pos", CASES, ids=IDS)
def test_ref_matches_jax_decode_and_full_attention(g, d, window, s, pos):
    hkv = 2
    q, ck, cv, p = _inputs(len(pos), s, hkv, g, d, pos)
    got = dref.decode_attention(q, ck, cv, p, window)
    assert got.shape == q.shape and got.dtype == q.dtype
    want = JT._decode_attention(jnp.asarray(q.numpy()), jnp.asarray(
        ck.numpy()), jnp.asarray(cv.numpy()), jnp.asarray(p.numpy()), window,
        None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kvpos = torch.arange(s, dtype=torch.int32).expand(len(pos), s)
    full = TT._attention_full(q, ck, cv, p[:, None], kvpos, window)
    torch.testing.assert_close(got, full, **TOL)


@pytest.mark.parametrize("g, d, window, s, pos", CASES, ids=IDS)
def test_noise_past_the_window_does_not_leak(g, d, window, s, pos):
    """Changing every entry a row cannot see leaves its output as it was."""
    q, ck, cv, p = _inputs(len(pos), s, 2, g, d, pos, seed=1)
    got = dref.decode_attention(q, ck, cv, p, window)
    t = torch.arange(s)[None, :, None, None]
    lo = (p - window + 1 if window else torch.zeros_like(p))
    hidden = (t > p[:, None, None, None]) | (t < lo[:, None, None, None])
    ck2 = torch.where(hidden, ck * 7 + 3, ck)
    cv2 = torch.where(hidden, -cv * 5 - 1, cv)
    assert torch.equal(dref.decode_attention(q, ck2, cv2, p, window), got)


def kernel_model(q, ck, cv, pos, window, nsplit):
    """B5's algorithm in plain torch: each row's visible positions [first,
    last] cut into ``nsplit`` spans as the kernel cuts them, a partial
    (max, sum, accumulator) per span, the spans merged by their maxima."""
    b, _, hq, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    g = hq // hkv
    out = torch.zeros((b, 1, hq, d), dtype=torch.float32)
    for r in range(b):
        p = int(pos[r])
        last = min(p, s - 1)
        first = max(0, p - window + 1) if window else 0
        n = last - first + 1
        chunk = -(-n // nsplit)
        parts = []
        for split in range(nsplit):
            s0 = first + split * chunk
            s1 = min(last + 1, s0 + chunk)
            if s1 <= s0:
                continue
            qg = q[r, 0].float().reshape(hkv, g, d)
            kk = ck[r, s0:s1].float().permute(1, 2, 0)        # (Hkv, D, T)
            sc = torch.matmul(qg, kk) / math.sqrt(d)           # (Hkv, g, T)
            m = sc.amax(-1, keepdim=True)
            e = torch.exp(sc - m)
            acc = torch.matmul(e, cv[r, s0:s1].float().permute(1, 0, 2))
            parts.append((m, e.sum(-1, keepdim=True), acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        num = sum(a * torch.exp(m - mx) for m, _, a in parts)
        out[r, 0] = (num / den).reshape(hq, d)
    return out.to(q.dtype)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7, 40])
@pytest.mark.parametrize("g, d, window, s, pos", CASES[::3],
                         ids=IDS[::3])
def test_split_model_matches_ref(g, d, window, s, pos, nsplit):
    q, ck, cv, p = _inputs(len(pos), s, 2, g, d, pos, seed=2)
    torch.testing.assert_close(kernel_model(q, ck, cv, p, window, nsplit),
                               dref.decode_attention(q, ck, cv, p, window),
                               **TOL)


def test_split_plan_is_a_function_of_the_shape():
    # DeepSeekMoE-16B at 160 requests: 2,560 (row, kv head) pairs fill the
    # card, one launch a layer
    assert dk.split_plan(160 * 16, 640) == 1
    # gemma3-4b in the smoke: 8 requests x 4 kv heads, positions split;
    # its local layers see at most the window
    assert dk.split_plan(8 * 4, 2080) == 17
    assert dk.split_plan(8 * 4, 1024) == 8
    assert dk.split_plan(8 * 4, 100) == 1       # too short to split
    assert dk.split_plan(1, 10 ** 6) == dk.H100_SMS * dk.BLOCKS_PER_SM
    for pairs in (1, 7, 32, 100, 527, 528, 2560):
        for span in (1, 127, 128, 129, 640, 2080):
            n = dk.split_plan(pairs, span)
            assert n == dk.split_plan(pairs, span) >= 1
            assert n == 1 or (pairs * (n - 1) < dk.H100_SMS * dk.BLOCKS_PER_SM
                              and (n - 1) * dk.MIN_SPLIT_POSITIONS < span)


def test_lanes_and_group_buckets():
    assert [dk.lanes_log2(d) for d in (8, 16, 24, 64, 128, 200, 256)] == [
        0, 1, 2, 3, 4, 5, 5]
    assert [dk.group_bucket(g) for g in range(1, 9)] == [1, 2, 4, 4, 8, 8,
                                                         8, 8]


def _c_smem_formula(src):
    """decode_attention_smem_bytes's formula, read from the source: the
    constants, the ring and the combine."""
    env = {n: int(v) for n, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", src, re.M)}
    assert re.search(r"return kWarps \* kStages \* kUnroll \* 2 \* "
                     r"\(bf16 \? 1 : 2\) \* 32 \* kVecBytes;", src)
    assert re.search(r"return kWarps \* group_bucket\(g\) \* \(d \+ 2\) \* "
                     r"static_cast<int>\(sizeof\(float\)\);", src)
    assert re.search(r"return ring > merge \? ring : merge;", src)

    def smem(d, g, bf16):
        ring = (env["kWarps"] * env["kStages"] * env["kUnroll"] * 2
                * (1 if bf16 else 2) * 32 * env["kVecBytes"])
        merge = env["kWarps"] * dk.group_bucket(g) * (d + 2) * 4
        return max(ring, merge)
    return env, smem


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_smem_estimate_matches_the_source_and_the_budget(dtype):
    env, smem = _c_smem_formula((CSRC / "decode_attention.cu").read_text())
    assert (dk.WARPS, dk.STAGES, dk.UNROLL, dk.VEC_BYTES, dk.VALS,
            dk.MAX_D) == (env["kWarps"], env["kStages"], env["kUnroll"],
                          env["kVecBytes"], env["kVals"], env["kMaxD"])
    for d in range(8, dk.MAX_D + 1, 8):
        for g in range(1, dk.MAX_GROUP + 1):
            got = dk.smem_bytes(d, g, dtype)
            assert got == smem(d, g, dtype == torch.bfloat16)
            assert got <= build.SMEM_BUDGET_BYTES


def test_built_with_the_other_kernels():
    assert "decode_attention" in build.SOURCES


def _ok(b=3, s=12, hkv=2, g=2, d=16):
    return _inputs(b, s, hkv, g, d, [0, 5, 11][:b])


@pytest.mark.parametrize("case, err, match", [
    ("float16", TypeError, "one dtype"),
    ("mixed dtypes", TypeError, "one dtype"),
    ("pos int64", TypeError, "int32"),
    ("two query tokens", ValueError, r"\(B, 1, Hq, D\)"),
    ("cache shapes differ", ValueError, r"\(B, 1, Hq, D\)"),
    ("batch differs", ValueError, "does not match"),
    ("non-contiguous cache", ValueError, "contiguous"),
    ("non-contiguous q", ValueError, "contiguous"),
    ("D = 12", ValueError, "multiple of 8"),
    ("D = 264", ValueError, "multiple of 8"),
    ("group 16", ValueError, "times the kv"),
    ("uneven group", ValueError, "times the kv"),
    ("window 0", ValueError, "positive"),
    ("CPU tensors", ValueError, "CUDA tensors"),
])
def test_wrapper_rules_raise(case, err, match):
    q, ck, cv, p = _ok()
    window = None
    if case == "float16":
        q, ck, cv = (x.half() for x in (q, ck, cv))
    elif case == "mixed dtypes":
        ck = ck.bfloat16()
    elif case == "pos int64":
        p = p.long()
    elif case == "two query tokens":
        q = torch.cat([q, q], 1)
    elif case == "cache shapes differ":
        cv = cv[:, :-1].contiguous()
    elif case == "batch differs":
        ck, cv = ck[:2].contiguous(), cv[:2].contiguous()
    elif case == "non-contiguous cache":
        ck = ck.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "non-contiguous q":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case in ("D = 12", "D = 264"):
        q, ck, cv, p = _ok(d=int(case.split()[-1]))
    elif case == "group 16":
        q, ck, cv, p = _ok(hkv=1, g=16)
    elif case == "uneven group":
        q = q[:, :, :3].contiguous()
    elif case == "window 0":
        window = 0
    with pytest.raises(err, match=match):
        dk.decode_attention(q, ck, cv, p, window)


def test_cpu_takes_the_plain_version():
    q, ck, cv, p = _inputs(4, 30, 2, 4, 16, [29, 0, 3, 17])
    launches = dk.LAUNCHES
    for window in (None, 5):
        assert torch.equal(dops.decode_attention(q, ck, cv, p, window),
                           dref.decode_attention(q, ck, cv, p, window))
        qb, kb, vb = (x.bfloat16() for x in (q, ck, cv))
        assert torch.equal(dops.decode_attention(qb, kb, vb, p, window),
                           dref.decode_attention(qb, kb, vb, p, window))
    assert dk.LAUNCHES == launches


def test_model_routes_a_plain_cache_through_the_op(monkeypatch):
    q, ck, cv, p = _inputs(2, 9, 2, 2, 16, [8, 3])
    calls = []

    def op(*args):
        calls.append(args)
        return dref.decode_attention(*args)

    monkeypatch.setattr(TT.decode_ops, "decode_attention", op)
    got = TT._decode_attention(q, ck, cv, p, 4)
    assert len(calls) == 1 and calls[0][-1] == 4
    assert torch.equal(got, dref.decode_attention(q, ck, cv, p, 4))


def test_dtensor_cache_keeps_the_matmul_path(tmp_path, monkeypatch):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import common as cm
    from tests import torch_mesh

    def never(*args):
        raise AssertionError("a DTensor cache reached the kernel's op")

    monkeypatch.setattr(TT.decode_ops, "decode_attention", never)
    q, ck, cv, p = _inputs(2, 10, 2, 2, 16, [9, 4])
    want = dref.decode_attention(q, ck, cv, p, 3)
    with torch_mesh.one_rank_mesh(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        # the plain tensors the model makes itself are replicated, as in
        # the mesh paths
        with cm.use_mesh(mesh), implicit_replication():
            seq = [Shard(0), Shard(1)]
            dq = distribute_tensor(q, mesh, [Shard(0), Replicate()])
            dck, dcv = (distribute_tensor(x, mesh, seq) for x in (ck, cv))
            dp = distribute_tensor(p, mesh, [Shard(0), Replicate()])
            got = TT._decode_attention(dq, dck, dcv, dp, 3)
            assert cm.is_dtensor(got)
            got = got.full_tensor()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
