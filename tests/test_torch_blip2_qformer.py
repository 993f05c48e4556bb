"""BLIP-2's stage-1 Q-Former in the port against the JAX package, tiny and
float32, the same weights carried across by ``load_jax_params``: the text
and query paths, the ITC similarity, the ITM logits (queries and text
sharing self-attention, each with its own FFN), ``compute_sim_matrix``'s
re-ranked scores, and the evaluate CLI's ``blip2_qformer`` retrieval branch
against the JAX CLI's, with its refusal outside ``--model_scale tiny``.

Tolerances: RTOL 1e-5 of the largest magnitude (float32, the same
operations in another order through 2 layers); the re-ranked matrices hold
-inf at the same entries; the recall metrics are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import blip2_qformer as jq
from ecoflap_tpu_torch.models import blip2_qformer as tq
from ecoflap_tpu_torch.models.convert import load_jax_params
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
# one compiled program each (the JAX package's eager forms compile every
# operation apart)
JIT_INIT = jax.jit(jq.init_params, static_argnums=0)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def jax_params(seed):
    return JIT_INIT(jq.tiny_config(), jax.random.PRNGKey(seed))


def port_model(params, build=tq.build_model):
    model = build(tq.tiny_config(), device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    return model


@pytest.fixture(scope="module")
def pair():
    params = jax_params(3)
    rng = np.random.default_rng(0)
    n = 6
    mask = np.ones((n, 8), np.int64)
    mask[1, 5:] = 0
    mask[4, 3:] = 0
    data = (rng.normal(size=(n, 8, 32)).astype(np.float32),
            rng.integers(3, 64, size=(n, 8)), mask)
    return params, port_model(params), data


def test_paths_sims_and_itm_logits_match_jax(pair):
    params, model, (emb, ids, mask) = pair
    cfg = jq.tiny_config()
    je, ji, jm = jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(mask)
    te, ti, tm = torch.from_numpy(emb), torch.from_numpy(ids), torch.from_numpy(mask)
    want = {name: jax.jit(getattr(jq, name), static_argnums=0) for name in (
        "encode_text", "encode_queries", "multimodal_forward", "itc_sim_matrix", "itm_score")}
    close(model.encode_text(ti, tm), want["encode_text"](cfg, params, ji, jm))
    close(model.encode_queries(te), want["encode_queries"](cfg, params, je))
    close(model.multimodal_forward(te, ti, tm),
          want["multimodal_forward"](cfg, params, je, ji, jm))
    close(model.itc_sim_matrix(te, ti, tm), want["itc_sim_matrix"](cfg, params, je, ji, jm))
    itm = want["itm_score"](cfg, params, je, ji, jm)
    close(model.itm_score(te, ti, tm), itm)
    # the text FFN is the text's own: changing it moves the text path and
    # the ITM output, never the query-only path
    q0 = model.encode_queries(te).clone()
    with torch.no_grad():
        for layer in model.layers:
            layer.output.dense.weight.mul_(2.0)
    assert torch.equal(model.encode_queries(te), q0)
    assert not np.allclose(model.itm_score(te, ti, tm).numpy(), np.asarray(itm))
    load_jax_params(model, flatten_named(params))


@pytest.mark.parametrize("n_txt, k", [(6, 3), (4, 5)])
def test_compute_sim_matrix_matches_jax(pair, n_txt, k):
    """Square, and 6 images by 4 texts at k 5, where each image re-ranks
    all 4 texts and each text its top 5 images (each side's k clipped to
    its candidates, as the JAX function clips it)."""
    params, model, (emb, ids, mask) = pair
    ids, mask = ids[:n_txt], mask[:n_txt]
    want = jq.compute_sim_matrix(jq.tiny_config(), params, jnp.asarray(emb), jnp.asarray(ids),
                                 jnp.asarray(mask), k_test=k)
    got = tq.compute_sim_matrix(model, torch.from_numpy(emb), torch.from_numpy(ids),
                                torch.from_numpy(mask), k_test=k)
    for g, w, shape in zip(got, want, ((6, n_txt), (n_txt, 6))):
        assert g.shape == w.shape == shape
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        assert (~np.isinf(g)).sum(axis=1).tolist() == [min(k, shape[1])] * shape[0]
        close(np.where(np.isinf(g), 0, g), np.where(np.isinf(w), 0, w))


def test_retrieval_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """The port's branch on the JAX CLI's init (its ``init_params`` at
    ``--seed``) gives the JAX CLI's recall metrics; outside tiny both CLIs
    end with the same message."""
    from ecoflap_tpu.cli.evaluate import main as jmain
    from ecoflap_tpu_torch.cli.evaluate import main as tmain

    monkeypatch.setattr(tq, "build_model", lambda cfg, **kw: port_model(jax_params(42)))
    argv = ["--model", "blip2_qformer", "--task", "retrieval", "--batch_size", "6"]
    want = jmain(argv + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tmain(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    assert {k: got[k] for k in want} == want
    assert set(got) == set(want) | {"eval_time_s"}
    messages = []
    for main, dev in ((jmain, ["--platform", "cpu"]), (tmain, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--model_scale", "full", "--output_dir", str(tmp_path)] + dev)
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "only --model_scale tiny" in messages[0]
