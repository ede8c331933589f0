"""The port's data pipeline (``repro_torch.data``) against the JAX package's.

* ``TokenFileLM.batch_at`` equals the JAX one on a flat int32 token file
  this test writes (from the synthetic stream's tokens), at every step
  through the wrap at ``n_seq``; iterating it gives the same batches.
* ``prefetch`` yields its source's items in order at depths 1 and 2, both
  packages'.
* A source that raises: the port's ``prefetch`` raises the same exception in
  the consumer after the items before it; the JAX one ends the stream there
  without one (it puts its stop mark in a ``finally``), a reference fault.
"""

import numpy as np
import pytest

from repro.data import pipeline as jdata

from repro_torch.data import DataConfig, SyntheticLM, TokenFileLM, prefetch


def _token_file(tmp_path, n_tokens, vocab=97):
    toks = np.concatenate([SyntheticLM(DataConfig(4, 63, vocab, seed=0)).batch_at(k)["tokens"]
                           .reshape(-1) for k in range(-(-n_tokens // 252))])[:n_tokens]
    path = tmp_path / "tokens.bin"
    toks.astype(np.int32).tofile(path)
    return str(path), toks


@pytest.mark.parametrize("batch,seq", [(3, 16), (2, 50)])
def test_token_file_batches_match_jax(tmp_path, batch, seq):
    path, toks = _token_file(tmp_path, 1000)
    cfg_j, cfg_t = jdata.DataConfig(batch, seq, 97), DataConfig(batch, seq, 97)
    port, ref = TokenFileLM(path, cfg_t), jdata.TokenFileLM(path, cfg_j)
    assert port.n_seq == ref.n_seq == (1000 - 1) // seq
    wrap = -(-port.n_seq // batch) + 1  # past the wrap at n_seq
    for k in range(wrap + 2):
        got, want = port.batch_at(k), ref.batch_at(k)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for key in got:
            assert got[key].dtype == np.int32 and got[key].shape == (batch, seq)
            np.testing.assert_array_equal(got[key], want[key])
    first = port.batch_at(0)["tokens"][0]
    np.testing.assert_array_equal(first, toks[:seq])
    it = iter(port)
    for k in range(3):
        np.testing.assert_array_equal(next(it)["labels"], port.batch_at(k)["labels"])


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_keeps_the_order(depth):
    items = [{"k": k} for k in range(7)]
    assert list(prefetch(iter(items), depth)) == items
    assert list(jdata.prefetch(iter(items), depth)) == items


def _failing(n):
    for k in range(n):
        yield k
    raise ValueError("the source failed")


# the JAX worker's exception escapes its thread, which pytest reports
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_raises_what_the_source_raised(depth):
    got = []
    with pytest.raises(ValueError, match="the source failed"):
        for item in prefetch(_failing(3), depth):
            got.append(item)
    assert got == [0, 1, 2]
    # the JAX version ends the stream there: the error is lost
    assert list(jdata.prefetch(_failing(3), depth)) == [0, 1, 2]
