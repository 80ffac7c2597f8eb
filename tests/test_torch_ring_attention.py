"""The port's sequence-parallel attention (``ops/ring_attention.py``)
against the JAX package on the same f32 inputs: ring attention — each hop
through the flash kernels' plain versions, merged by logsumexp, and the
plain block ring — and Ulysses, at seq 2 and 4, causal and full, o and
dq/dk/dv from one upstream gradient, against JAX's ``ring_attention(impl=
"xla")``, ``ulysses_attention`` and ``full_attention`` inside
``shard_map`` (atol 1e-5). bf16 inputs accumulate in f32 (against the f32
reference at 2e-2, as ``tests/test_transformer.py`` holds JAX's ring).
The port's ranks are 4 gloo processes spawned once per module; each case
lays them out as its own mesh (``parallel/workers.on_meshes``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_model_parallel_tpu.config import MeshConfig as JMesh
from distributed_model_parallel_tpu.mesh import make_mesh
from distributed_model_parallel_tpu.ops.ring_attention import (
    full_attention,
    ring_attention,
    ulysses_attention,
)
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.config import MeshConfig
from distributed_model_parallel_tpu_torch.ops import ring_attention as tra
from distributed_model_parallel_tpu_torch.parallel import workers

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
B, T, H, DH = 2, 32, 4, 8
# name -> (seq ways, port sp_impl, port impl, causal, JAX reference)
CASES = {
    f"{kind}_seq{n}_{'causal' if causal else 'full'}":
        (n, sp, impl, causal, ref)
    for n in (2, 4) for causal in (True, False)
    for kind, sp, impl, ref in (("ring_flash", "ring", "flash", "ring"),
                                ("ring_xla", "ring", "xla", "ring"),
                                ("ring_auto", "ring", "auto", "ring"),
                                ("ulysses", "ulysses", "auto", "ulysses"))
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, H, DH)).astype(np.float32)
                 for _ in range(4))


def _mesh(n):
    """4 ranks as a mesh whose seq axis has n ranks."""
    return MeshConfig(data=4 // n, seq=n)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    q, k, v, do = _inputs()
    cases = [(_mesh(n), "seq_attention", (q, k, v, do, sp, impl, causal))
             for n, sp, impl, causal, _ in CASES.values()]
    cases += [(_mesh(4), "seq_attention", (q, k, v, do, "ring", impl, True,
                                           "bfloat16"))
              for impl in ("flash", "xla")]
    return tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                       timeout_s=300,
                       store_dir=str(tmp_path_factory.mktemp("store")))


def _gather(port, i, n, key):
    """The whole [B, T, ...] array of case i from the ranks of data row 0
    (ranks 0..n-1 hold seq shards 0..n-1)."""
    return np.concatenate([port[r][i][key] for r in range(n)], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_full(causal):
    """(o, (dq, dk, dv)) of JAX's single-device ``full_attention``."""
    q, k, v, do = _inputs()
    o, vjp = jax.vjp(lambda q, k, v: full_attention(q, k, v, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _jax_sp(n, ref, causal):
    """(o, (dq, dk, dv)) of JAX's sequence-parallel attention inside
    ``shard_map`` (each compile takes tens of seconds on the CPU, so the
    cases against it are few)."""
    q, k, v, do = _inputs()
    spec = make_mesh(JMesh(data=1, seq=n))
    fn = (lambda q, k, v: ring_attention(q, k, v, "seq", causal=causal,
                                         impl="xla")) if ref == "ring" else \
        (lambda q, k, v: ulysses_attention(q, k, v, "seq", causal=causal,
                                           impl="xla"))
    f = jax.shard_map(fn, mesh=spec.mesh, in_specs=(P(None, "seq"),) * 3,
                      out_specs=P(None, "seq"), check_vma=False)
    o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _check(port, name, want):
    i = list(CASES).index(name)
    n = CASES[name][0]
    o_ref, g_ref = want
    np.testing.assert_allclose(_gather(port, i, n, "o"), o_ref, atol=ATOL,
                               rtol=0)
    for key, ref in zip(("dq", "dk", "dv"), g_ref):
        np.testing.assert_allclose(_gather(port, i, n, key), ref,
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_output_and_grads_match_jax_full_attention(port, name):
    """Every case against JAX's ``full_attention`` over the whole
    sequence."""
    _check(port, name, _jax_full(CASES[name][3]))


@pytest.mark.parametrize("name", ["ring_flash_seq2_causal",
                                  "ring_xla_seq2_causal",
                                  "ulysses_seq2_causal"])
def test_matches_jax_sequence_parallel(port, name):
    """Against JAX's own ring (``impl="xla"``) and Ulysses attention on a
    ``seq=2`` mesh."""
    n, _, _, causal, ref = CASES[name]
    _check(port, name, _jax_sp_cached(n, ref, causal))


_jax_sp_cached = functools.lru_cache(maxsize=None)(_jax_sp)


@pytest.mark.parametrize("which", [0, 1], ids=["flash", "xla"])
def test_bf16_inputs_accumulate_f32(port, which):
    """bf16 q/k/v through the ring at seq 4: within bf16 input rounding of
    the f32 reference (f32 accumulation across the hops)."""
    i = len(CASES) + which
    q, k, v, _ = _inputs()
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    ref = full_attention(*map(jnp.asarray, (bf(q), bf(k), bf(v))),
                         causal=True)
    np.testing.assert_allclose(_gather(port, i, 4, "o"), np.asarray(ref),
                               atol=2e-2, rtol=2e-2)


def test_merge_by_lse_and_skipped_hops():
    """The lse merge against the joint softmax, and the NEG sentinel of a
    skipped hop merging as a no-op (never NaN)."""
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.standard_normal((1, 2, 3, 10))).float()
    v = torch.from_numpy(rng.standard_normal((1, 10, 2, 4))).float()

    def part(lo, hi):
        ss = s[..., lo:hi]
        lse = torch.logsumexp(ss, -1)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(ss, -1),
                         v[:, lo:hi])
        return o, lse

    o, lse = tra.merge_by_lse(*part(0, 4), *part(4, 10))
    o_ref, lse_ref = part(0, 10)
    torch.testing.assert_close(o, o_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-6, rtol=0)
    skip = (torch.zeros_like(o), torch.full_like(lse, tra.NEG))
    o2, lse2 = tra.merge_by_lse(o, lse, *skip)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert [tra.hop_is_full(2, h) for h in range(4)] == [True, True, True,
                                                         False]


def test_refusals_in_jax_words():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="unknown ring impl"):
        tra.ring_attention(q, q, q, None, impl="pallas")
    with pytest.raises(ValueError, match="unknown ring impl"):
        tra.ulysses_attention(q, q, q, None, impl="pallas")


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_off_cpu_shapes_the_kernels_refuse_raise(fn, impl):
    """Off the CPU, "auto" is "flash": a shard the kernels do not take
    (f32 here, on the meta device, which no kernel runs on) reaches the
    kernels' own checks and raises; it never runs the plain attention."""
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        getattr(tra, fn)(q, q, q, None, impl=impl)
