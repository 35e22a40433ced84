"""The port's op analysis (``launch/op_analysis.py``) against the
reference's HLO analysis on the same programs (``tests/test_hlo_analysis.py``'s
cases, run on both sides), and the radix kernels' work notes.

* 9 steps of ``tanh(h @ w)``: the port's flops within the reference's
  bar ``[N * one, 1.2 * N * one]``; 9 steps of ``h @ w``: flops equal to
  the reference's dot flops;
* the all-gather of an (8, 32) float32 shard over 8 ranks: ``7 * 8 * 32
  * 4`` link bytes on both sides (the port on a ``fake`` world of 8,
  made and destroyed by a fixture);
* a convolution and a collective permute: the reference's flops and
  link bytes;
* a radix product counts as the reference's int8 dot (flops and bytes),
  once, through ``ops.radix_matmul`` and ``lm.radix._int_product``, on
  the CPU and under fake tensors; decode attention and the encoder note
  ``kernels/work.py``'s reckoning;
* a DTensor op counts at its local shapes, also the second time (when
  DTensor's sharding propagation is cached); an op on meta tensors
  counts nothing; gathers and in-place updates count their slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import compat
from repro.launch import hlo_analysis as HA
from repro_torch.kernels import ops, work
from repro_torch.launch.op_analysis import analyze
from repro_torch.lm import radix as tradix

N, M = 9, 64
ONE = 2 * 8 * M * M


@pytest.fixture
def fake_world():
    """This process as rank 0 of a ``fake`` group of 8 ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ref_cost(f, *shapes, mesh=None, in_shardings=None):
    structs = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    jf = jax.jit(f) if in_shardings is None else jax.jit(
        f, in_shardings=in_shardings)
    if mesh is None:
        c = jf.lower(*structs).compile()
    else:
        with compat.set_mesh(mesh):
            c = jf.lower(*structs).compile()
    return HA.analyze(c.as_text())


def _rng_t(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("act", [True, False])
def test_scan_steps_flops(act):
    def jf(w, x):
        def body(h, _):
            h = h @ w
            return (jnp.tanh(h) if act else h), None
        h, _ = jax.lax.scan(body, x, None, length=N)
        return h

    def tf(w, x):
        h = x
        for _ in range(N):
            h = h @ w
            h = torch.tanh(h) if act else h
        return h

    ref = _ref_cost(jf, ((M, M), jnp.float32), ((8, M), jnp.float32))
    _, got = analyze(tf, _rng_t(M, M), _rng_t(8, M, seed=1))
    assert N * ONE <= got.flops <= N * ONE * 1.2, (got.flops, N * ONE)
    assert N * ONE <= ref.flops <= N * ONE * 1.2
    assert got.ops["aten.mm"] == N
    if not act:                       # the dot flops, equal on both sides
        assert got.flops == ref.flops == N * ONE
    # FlopCounterMode's total over the same call: the products
    assert got.raw_flops == N * ONE


def test_all_gather_ring_bytes_match_reference(fake_world):
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import make_mesh

    jmesh = compat.make_mesh((8,), ("model",))

    def jf(x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(jmesh, P(None, None))).sum()

    ref = _ref_cost(jf, ((64, 32), jnp.float32), mesh=jmesh,
                    in_shardings=NamedSharding(jmesh, P("model", None)))
    mesh = make_mesh((8,), ("model",))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 32), mesh, (Shard(0),),
                               run_check=False)
        _, got = analyze(lambda t: t.full_tensor().sum(), x)
    want = 7 * 8 * 32 * 4
    assert got.per_collective["all-gather"] == want
    assert ref.per_collective["all-gather"] == pytest.approx(want, rel=0.01)
    assert got.collective_bytes == want


def test_permute_link_bytes_match_reference(fake_world):
    from repro.compat import shard_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C

    jmesh = compat.make_mesh((8,), ("pod",))

    def jf(x):
        return shard_map(lambda v: jax.lax.ppermute(
            v, "pod", [(i, (i + 1) % 8) for i in range(8)]), mesh=jmesh,
            in_specs=P("pod"), out_specs=P("pod"))(x)

    ref = _ref_cost(jf, ((64, 8), jnp.float32), mesh=jmesh)
    mesh = make_mesh((8,), ("pod",))
    with FakeTensorMode():
        _, got = analyze(lambda t: C.permute(t, mesh, "pod"),
                         torch.empty(8, 8))
    assert got.per_collective == {"collective-permute": 8 * 8 * 4}
    assert ref.per_collective["collective-permute"] == 8 * 8 * 4


def test_conv_flops_match_reference():
    x = (2, 12, 12, 5)              # NHWC
    w = (3, 3, 5, 7)                # HWIO

    def jf(a, k):
        return jax.lax.conv_general_dilated(
            a, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    ref = _ref_cost(jf, (x, jnp.float32), (w, jnp.float32))
    _, got = analyze(torch.nn.functional.conv2d, _rng_t(2, 5, 12, 12),
                     _rng_t(7, 5, 3, 3, seed=1))
    assert got.flops == ref.flops == 2 * (2 * 10 * 10 * 7) * (3 * 3 * 5)


def _ref_int8_dot(m, k, n):
    def jf(a, b):
        return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    return _ref_cost(jf, ((m, k), jnp.int8), ((k, n), jnp.int8))


@pytest.mark.parametrize("fake", [False, True])
@pytest.mark.parametrize("route", ["ops", "int_product"])
def test_radix_product_counts_as_reference_int8_dot(fake, route):
    m, k, n = 24, 64, 40
    ref = _ref_int8_dot(m, k, n)
    rng = np.random.default_rng(0)
    qx = torch.from_numpy(rng.integers(0, 16, (m, k), dtype=np.uint8))
    qw = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    call = ((lambda a, b: ops.radix_matmul(a, b, None, 4)) if route == "ops"
            else tradix._int_product)
    if fake:
        mode = FakeTensorMode()
        qx, qw = mode.from_tensor(qx), mode.from_tensor(qw)
        with mode:
            _, got = analyze(call, qx, qw)
    else:
        _, got = analyze(call, qx, qw)
    assert got.flops == ref.flops == 2 * m * k * n
    assert got.bytes == ref.bytes == m * k + k * n + 4 * m * n
    assert got.ops.get("radix_matmul") == 1
    assert not any(name.startswith("aten.mm") for name in got.ops)


def test_kernel_notes_follow_work_reckoning():
    rng = np.random.default_rng(0)
    b, s_len, hkv, g, hd = 2, 16, 2, 2, 8
    q = torch.from_numpy(rng.standard_normal((b, hkv * g, hd)).astype(
        np.float32))
    lv = [torch.from_numpy(rng.integers(0, 16, (b, s_len, hkv, hd),
                                        dtype=np.uint8)) for _ in range(2)]
    sc = [torch.ones(b, s_len, hkv) for _ in range(2)]
    mask = torch.ones(b, s_len, dtype=torch.bool)
    _, got = analyze(ops.radix_decode_attention, q, lv[0], sc[0], lv[1],
                     sc[1], mask, 4)
    w = work.decode_attn(b, s_len, hkv, g, hd, packed=False, q_bytes=4)
    assert (got.flops, got.bytes, got.ops.get("radix_decode_attn")) == (
        w.ops, w.nbytes, 1)
    x = torch.rand(3, 5, 7)
    _, got = analyze(ops.radix_encode, x, 4)
    w = work.encode(x.numel())
    assert (got.flops, got.bytes, got.ops.get("spike_encode")) == (
        w.ops, w.nbytes, 1)
    xq = torch.from_numpy(rng.integers(0, 16, (1, 6, 6, 3), dtype=np.uint8))
    wq = torch.from_numpy(rng.integers(-7, 8, (3, 3, 3, 4), dtype=np.int8))
    _, got = analyze(ops.radix_conv2d, xq, wq, None, 4, padding="SAME")
    w = work.gemm("radix_conv2d", 36, 27, 4, x_bytes=8 * 8 * 3,
                  epilogue=False, occupancy=False)
    pad = 6 * 6 * 3 + 8 * 8 * 3          # SAME's pre-pad, outside the kernel
    assert (got.flops, got.bytes, got.ops.get("radix_conv2d")) == (
        w.ops, w.nbytes + pad, 1)
    # outside an analysis nothing is noted
    assert work._SINKS == []


def test_dtensor_op_counts_local_shapes(fake_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"))
    with FakeTensorMode():
        w = DTensor.from_local(torch.empty(64, 8), mesh,
                               (Replicate(), Shard(1)), run_check=False)
        x = DTensor.from_local(torch.empty(8, 64), mesh,
                               (Replicate(), Replicate()), run_check=False)
        for _ in range(2):          # the second time propagation is cached
            out, got = analyze(lambda a, b: a @ b, x, w)
            assert tuple(out.shape) == (8, 32)
            assert got.flops == 2 * 8 * 64 * 8        # local (8,64)@(64,8)
            assert got.ops["aten.mm"] == 1
            assert got.bytes == 4 * (8 * 64 + 64 * 8 + 8 * 8)


def test_meta_ops_and_slices():
    _, got = analyze(lambda: torch.empty(4, 4, device="meta")
                     @ torch.empty(4, 4, device="meta"))
    assert got.flops == 0 and got.bytes == 0

    table = torch.zeros(1000, 16)
    idx = torch.tensor([3, 5, 7])
    _, got = analyze(lambda t, i: t[i], table, idx)     # reads the rows
    assert got.bytes == 2 * 3 * 16 * 4 + 3 * 8

    buf = torch.zeros(1000, 16)
    upd = torch.ones(2, 16)
    _, got = analyze(lambda b, u: b[10:12].copy_(u), buf, upd)
    assert got.bytes == 2 * 2 * 16 * 4                  # the slice written
    assert got.flops == 0


def test_kernel_refuses_fake_cuda_tensors():
    """A fake CUDA tensor reaches the launch path: it raises, it does not
    pretend to launch (the plain version runs on fake CPU tensors)."""
    from repro_torch.kernels.radix_attn import radix_decode_attn_cuda
    from repro_torch.kernels.radix_matmul import radix_matmul_cuda
    from repro_torch.kernels.spike_encode import spike_encode_cuda

    mode = FakeTensorMode(allow_non_fake_inputs=False)
    with mode:
        dev = torch.device("cuda")
        qx = torch.empty(4, 8, dtype=torch.uint8, device=dev)
        qw = torch.empty(8, 4, dtype=torch.int8, device=dev)
        with pytest.raises(ValueError, match="fake tensor"):
            radix_matmul_cuda(qx, qw, num_steps=4)
        with pytest.raises(ValueError, match="fake tensor"):
            spike_encode_cuda(torch.empty(3, device=dev), num_steps=4)
        q = torch.empty(1, 2, 8, device=dev)
        lv = torch.empty(1, 4, 1, 8, dtype=torch.uint8, device=dev)
        sc = torch.empty(1, 4, 1, device=dev)
        with pytest.raises(ValueError, match="fake tensor"):
            radix_decode_attn_cuda(q, lv, sc, lv, sc,
                                   torch.ones(1, 4, dtype=torch.bool,
                                              device=dev), num_steps=4)
    assert radix_matmul_cuda.launches == 0
