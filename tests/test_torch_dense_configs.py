"""The port's registry (``repro_torch.configs``: the dense family, the moe
``qwen2_moe_a2_7b`` and ``deepseek_v3_671b``, the vlm
``llava_next_mistral_7b`` and the encdec ``whisper_tiny``) against the JAX
package's.

* Every ported arch (``ARCH_IDS`` + ``PAPER_IDS``): ``CONFIG`` and
  ``reduced()`` equal the JAX package's field for field.
* ``shapes.cells_for`` and ``all_cells`` give the JAX package's cells and
  skip reasons over the ported archs.
* Every JAX arch outside the dense family either raises
  ``NotImplementedError`` naming the arch and the family it lacks, or,
  once ported (``qwen2_moe_a2_7b``; ``deepseek_v3_671b`` with the ``mla``
  kind; ``llava_next_mistral_7b`` with its patch front; ``whisper_tiny``
  with the ``encdec`` kind), loads.
* ``fixed_state_bytes`` and ``ActivationByteModel.from_config`` equal the
  JAX package's exactly on the reduced and full-width gpt3_1_5b,
  gemma2_2b (period-2 pattern, padded groups) and qwen2_moe_a2_7b (3-D
  expert stacks, the float32 router; its moe activations priced at one
  expert's width in both, the JAX formula kept).
* ``rope`` at the odd half widths of the new head sizes (48 of 96, 144 of
  288) against the JAX rope in f32: within 1e-5 below position 64, 1e-3
  around position 4100 (``ROPE_TOL``).
* ``params_from_numpy`` carries a period-2 ``blocks`` tuple and the MHA
  ``wk``/``wv`` over leaf for leaf.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core.memory import ActivationByteModel as JaxByteModel  # noqa: E402
from repro.core.planner import fixed_state_bytes as jax_fixed_state_bytes  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core.memory import ActivationByteModel  # noqa: E402
from repro_torch.core.planner import fixed_state_bytes  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.tree import keyed_leaves  # noqa: E402

PORTED = configs.ARCH_IDS + configs.PAPER_IDS
DENSE = ["gpt3_1_5b", "gpt3_6_2b", "gpt3_14_6b", "gpt3_28_3b", "deepseek_67b", "minitron_8b",
         "gemma2_2b", "internlm2_1_8b"]
MOE = ["deepseek_v3_671b", "qwen2_moe_a2_7b"]
FRONT = {"llava_next_mistral_7b": "vlm", "whisper_tiny": "encdec"}  # the fronted families
RECURRENT = {"xlstm_350m": "ssm", "recurrentgemma_9b": "hybrid"}  # the recurrent families
# the JAX archs outside the dense family, ported since or not
UNPORTED = [a for a in jconfigs.ARCH_IDS if a not in DENSE]
FAMILIES = ("moe", "mla", "encdec", "vlm", "ssm", "hybrid")
NEW = ["gpt3_1_5b", "gemma2_2b", "qwen2_moe_a2_7b", "deepseek_v3_671b"]


def test_the_port_carries_the_dense_family():
    assert sorted(PORTED) == sorted(DENSE + MOE + list(FRONT) + list(RECURRENT))
    assert configs.PAPER_IDS == jconfigs.PAPER_IDS
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS  # every assigned arch, in the JAX order
    assert sorted(configs.all_configs()) == sorted(DENSE + MOE + list(FRONT) + list(RECURRENT))


@pytest.mark.parametrize("arch", DENSE + MOE + list(FRONT) + list(RECURRENT))
@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_matches_jax_field_for_field(arch, which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "CONFIG"
                 else (configs.get_reduced, jconfigs.get_reduced))
    mine, ref = get(arch), jget(arch)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.family == ("moe" if arch in MOE else {**FRONT, **RECURRENT}.get(arch, "dense"))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_cells_match_jax(arch):
    assert shapes.SHAPES == {k: shapes.ShapeCell(*dataclasses.astuple(v))
                             for k, v in jshapes.SHAPES.items()}
    mine = [(sid, dataclasses.astuple(c), skip) for sid, c, skip in shapes.cells_for(arch)]
    ref = [(sid, dataclasses.astuple(c), skip) for sid, c, skip in jshapes.cells_for(arch)]
    assert mine == ref


def test_all_cells_match_jax_over_the_ported_archs():
    mine = [(a, sid, dataclasses.astuple(c), skip) for a, sid, c, skip in shapes.all_cells()]
    ref = [(a, sid, dataclasses.astuple(c), skip) for a, sid, c, skip in jshapes.all_cells()
           if a in configs.ARCH_IDS]
    assert mine == ref and len(mine) == 4 * len(configs.ARCH_IDS)


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_arch_raises_naming_what_it_lacks(arch):
    family = jconfigs.get_config(arch).family
    if arch in configs.ARCH_IDS:  # ported since: it loads, and nothing names it
        assert arch in MOE + list(FRONT) + list(RECURRENT)
        assert configs.get_config(arch).family == family
        assert arch not in configs.UNPORTED_ARCHS
        if arch == "deepseek_v3_671b":  # with its mla kind
            assert "mla" in configs.get_config(arch).block_pattern[0]
            assert "mla" in tmod.PORTED_KINDS
        if arch == "whisper_tiny":  # with its encdec kind
            assert configs.get_config(arch).block_pattern == (("encdec",),)
            assert "encdec" in tmod.PORTED_KINDS
        if arch in RECURRENT:  # with its recurrent kinds
            kinds = {k for blk in configs.get_config(arch).block_pattern for k in blk}
            assert kinds & {"slstm", "mlstm", "rglru"}
            assert kinds <= set(tmod.PORTED_KINDS) and not tmod.UNPORTED_KINDS
        return
    for get in (configs.get_config, configs.get_reduced):
        with pytest.raises(NotImplementedError, match=arch) as err:
            get(arch)
        msg = str(err.value)
        assert family in msg
        assert any(f in msg for f in FAMILIES)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="no_such_arch"):
        configs.get_config("no_such_arch")


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_fixed_state_bytes_match_jax(arch, full, n_chunks):
    get, jget = ((configs.get_config, jconfigs.get_config) if full
                 else (configs.get_reduced, jconfigs.get_reduced))
    for p in (2, 4):
        assert fixed_state_bytes(get(arch), p, n_chunks) == \
            jax_fixed_state_bytes(jget(arch), p, n_chunks)


BYTE_FIELDS = ("m_b_bytes", "m_w_bytes", "per_layer_act", "per_layer_wctx", "layers_per_stage",
               "tokens", "dtype_bytes")


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
def test_byte_model_matches_jax(arch, full):
    cfg = configs.get_config(arch) if full else configs.get_reduced(arch)
    cfg_j = jconfigs.get_config(arch) if full else jconfigs.get_reduced(arch)
    for b, s in ((1, 1024), (2, 32), (1, 4100)):
        for p, C in ((4, 1), (4, 2), (2, 2)):
            for compact in (True, False):
                mine = ActivationByteModel.from_config(cfg, b, s, p, n_chunks=C, compact=compact)
                ref = JaxByteModel.from_config(cfg_j, b, s, p, n_chunks=C, compact=compact)
                assert {f: getattr(mine, f) for f in BYTE_FIELDS} == \
                    {f: getattr(ref, f) for f in BYTE_FIELDS}


# rope in f32: the angle is position x frequency, and the two frameworks'
# exp may give a frequency one ulp apart (6e-8 relative), which moves the
# angle at position ~4100 by ~2.5e-4 rad; below position 64 by < 4e-6 rad
ROPE_TOL = {0: 1e-5, 4090: 1e-3}


@pytest.mark.parametrize("start", sorted(ROPE_TOL))
@pytest.mark.parametrize("head_dim", [96, 288, 6])
def test_rope_matches_jax_at_odd_half_widths(head_dim, start):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 37, 3, head_dim)).astype(np.float32)
    pos = np.arange(start, start + 37)
    want = jmod.rope(jnp.asarray(x), jnp.asarray(pos))
    got = tmod.rope(torch.from_numpy(x), torch.from_numpy(pos))
    tol = ROPE_TOL[start]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_params_carry_over_leaf_for_leaf(arch, n_chunks):
    cfg = jconfigs.get_reduced(arch)
    p = 2
    placement = JaxPlacement.vshape(p) if n_chunks == 2 else JaxPlacement.linear(p)
    spec = jlm.RunSpec(p=p, n_chunks=n_chunks, microbatch=1, seq_len=8, m=1)
    stacked_j, shared_j = jlm.init_params(cfg, spec, placement)
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    stacked_t, shared_t = params_from_numpy(*np_tree, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(np_tree)
    got = keyed_leaves((stacked_t, shared_t))
    assert len(got) == len(want)
    for (kt, t), (kj, a) in zip(got, want):
        assert kt == jax.tree_util.keystr(kj)
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape, kt
        np.testing.assert_array_equal(t.numpy(), a, err_msg=kt)
    blocks = stacked_t[0]["blocks"]
    if arch == "gemma2_2b":  # the group holds whole periods of the pattern
        assert len(blocks) % 2 == 0
    if arch == "deepseek_v3_671b":  # mla: one latent feeds k and v
        assert blocks[0][0]["wuk"].shape == blocks[0][0]["wuv"].shape
        return
    attn = blocks[0][0]
    assert attn["wk"].shape == attn["wv"].shape
    if arch == "gpt3_1_5b":  # multi-head: as many kv heads as q heads
        assert attn["wk"].shape == attn["wq"].shape
