"""The T5 SparseGPT witness: where do the port's masks part from the JAX
package's on the prune CLI's own five-word batch, and why?

For each of the tiny T5's four blocks (two encoder, two decoder), in the
JAX run's own stream (block inputs from the JAX-pruned blocks before it),
each linear's float32 Hessian H is built from its recorded inputs X by the
JAX ``accumulate_hessian``; then the weight W is pruned from that one H four
ways:

  (a) the JAX sweep the CLI takes: ``sparsegpt_prune_weight_group`` for a
      block's same-shape linears, ``sparsegpt_prune_weight`` for the rest,
      in float32;
  (b) the port's sweep in float32;
  (c) the port's sweep in float64 (H widened from the same float32 H);
  (d) a plain float64 numpy OBS sweep written here from SparseGPT's
      ``fasterprune``: the undamped Cholesky first and cumulative diagonal
      damping on failure, the upper Cholesky factor of the inverse, the
      per-block saliency threshold, the column loop and the cross-block
      update.

The flip shares (a-b), (a-c), (b-c), (c-d) and each side's OBS objective
||(W - W')X||^2 are printed per linear and per block (``-s``). Reading:
(c) and (d) agree, and (a-b) is no larger than (a-c) and (b-c), so both
float32 sweeps are equal roundings of one float64 answer (ROADMAP.md,
section 3, accepted differences). The bounds assert that reading: (c-d)
at most 1e-3 of a block's entries, and per block (a-b) <= max((a-c),
(b-c)). The JAX package's ``prepare_hinv`` reports each H's dead columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.cli import prune as jcli
from ecoflap_tpu.models import t5 as jt5
from ecoflap_tpu.pruning import sparsegpt as jsg
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.pruning import sparsegpt as tsg
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RATIO = 0.5  # the CLI's --prune_spec 2-0.5-1.0-1.0
CD_SHARE = 1e-3  # (c) vs (d): float64 against float64


def numpy_obs(w, h, sparsity, blocksize=128, percdamp=0.01):
    """SparseGPT's ``fasterprune`` in float64 numpy (unstructured)."""
    w = np.array(w, np.float64)
    h = np.array(h, np.float64)
    cols = w.shape[1]
    dead = np.diag(h) == 0
    h[dead, dead] = 1.0
    w[:, dead] = 0.0

    def robust_cholesky(m, damp):
        for _ in range(51):
            try:
                return np.linalg.cholesky((m + m.T) / 2)
            except np.linalg.LinAlgError:
                m = m + damp * np.eye(len(m))
        raise np.linalg.LinAlgError("no factor after 50 dampings")

    chol = robust_cholesky(h, percdamp * np.mean(np.diag(h)))
    inv_l = np.linalg.inv(chol)
    hinv_full = inv_l.T @ inv_l
    hinv = robust_cholesky(hinv_full, percdamp * np.mean(np.abs(np.diag(hinv_full)))).T
    for i1 in range(0, cols, blocksize):
        i2 = min(i1 + blocksize, cols)
        w1 = w[:, i1:i2].copy()
        q1 = np.zeros_like(w1)
        err1 = np.zeros_like(w1)
        hinv1 = hinv[i1:i2, i1:i2]
        sal = w1 ** 2 / np.diag(hinv1)[None, :] ** 2
        idx = min(max(int(np.floor(np.float32(sparsity) * sal.size)), 0), sal.size - 1)
        mask1 = sal <= np.sort(sal.reshape(-1))[idx]
        for i in range(i2 - i1):
            q = np.where(mask1[:, i], 0.0, w1[:, i])
            err = (w1[:, i] - q) / hinv1[i, i]
            w1[:, i:] -= np.outer(err, hinv1[i, i:])
            q1[:, i] = q
            err1[:, i] = err
        w[:, i1:i2] = q1
        w[:, i2:] -= err1 @ hinv[i1:i2, i2:]
    return w


def flips(a, b):
    return float(np.mean((np.asarray(a) == 0) != (np.asarray(b) == 0)))


def objective(w, w2, x):
    d = np.asarray(w, np.float64) - np.asarray(w2, np.float64)
    return float(np.sum((d @ np.asarray(x, np.float64).T) ** 2))


def shape_groups(stack, bp):
    groups = {}
    for local in stack.linear_names:
        groups.setdefault(tuple(stack.weight_get(bp, local).shape), []).append(local)
    return list(groups.values())


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    """Per block: {linear: {pair: flip share, side: objective}} along the
    JAX run's stream."""
    cfg = jt5.tiny_config()
    params = jt5.init_params(cfg, jax.random.PRNGKey(3))
    ckpt = str(tmp_path_factory.mktemp("witness") / "tiny_t5.pth")
    jck.save_torch_checkpoint(jck.export_t5(params, cfg), ckpt)
    args = jcli.build_parser().parse_args(
        ["--model", "t5", "--model_scale", "tiny", "--ckpt", ckpt, "--num_samples", "8",
         "--batch_size", "4", "--platform", "cpu"])
    adapter, batch, _, _ = jcli._configs(args)
    params = adapter.params

    recorded = {}

    def record(stats, name, x, collect):
        if collect == "x":
            recorded[name] = x.reshape(-1, x.shape[-1]).astype(jnp.float32)

    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jt5, "collect_stats", record)
    try:
        for stack in adapter.stacks:
            x, cache = stack.prepare_inputs(params, batch)
            for i in range(stack.num_blocks):
                bp = stack.get_block(params, i)
                recorded.clear()
                stack.block_forward(bp, x, cache, "x")
                n_seq = x.shape[0]
                block = {}
                for group in shape_groups(stack, bp):
                    ws = [np.asarray(stack.weight_get(bp, ln), np.float32) for ln in group]
                    hs = []
                    for ln in group:
                        h, _ = jsg.accumulate_hessian(
                            jnp.zeros((ws[0].shape[1],) * 2, jnp.float32), 0.0,
                            recorded[ln].reshape(n_seq, -1, ws[0].shape[1]))
                        hs.append(np.asarray(h))
                    if len(group) >= 2:
                        a = np.asarray(jsg.sparsegpt_prune_weight_group(
                            jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(hs)),
                            jnp.full((len(group),), RATIO, jnp.float32)))
                    else:
                        a = np.asarray(jsg.sparsegpt_prune_weight(
                            jnp.asarray(ws[0]), jnp.asarray(hs[0]), jnp.float32(RATIO)))[None]
                    tw, th = torch.from_numpy(np.stack(ws)), torch.from_numpy(np.stack(hs))
                    ratios = [RATIO] * len(group)
                    b = tsg.sparsegpt_prune_weight_group(tw, th, ratios).numpy()
                    c = tsg.sparsegpt_prune_weight_group(tw.double(), th.double(),
                                                         ratios).numpy()
                    for k, ln in enumerate(group):
                        d = numpy_obs(ws[k], hs[k], RATIO)
                        _, dead = jsg.prepare_hinv(jnp.asarray(hs[k]))
                        xk = np.asarray(recorded[ln])
                        block[ln] = {
                            "ab": flips(a[k], b[k]), "ac": flips(a[k], c[k]),
                            "bc": flips(b[k], c[k]), "cd": flips(c[k], d),
                            "numel": ws[k].size, "dead": int(np.sum(np.asarray(dead))),
                            "rank": int(np.linalg.matrix_rank(hs[k].astype(np.float64))),
                            "size": ws[k].shape[1],
                            **{f"obj_{s}": objective(ws[k], v, xk)
                               for s, v in (("a", a[k]), ("b", b[k]), ("c", c[k]),
                                            ("d", d))}}
                        bp = stack.weight_set(bp, ln, jnp.asarray(a[k]))
                params = stack.set_block(params, i, bp)
                x, _ = stack.block_forward(bp, x, cache, None)
                out[f"{stack.name}.{i}"] = block
    finally:
        mp.undo()
    return out


def _share(block, pair):
    return sum(r[pair] * r["numel"] for r in block.values()) / sum(
        r["numel"] for r in block.values())


def test_witness_reads_as_equal_roundings_of_one_float64_answer(witness):
    assert len(witness) == 4
    for name, block in witness.items():
        shares = {p: _share(block, p) for p in ("ab", "ac", "bc", "cd")}
        print(f"{name}: flip shares (a-b) {shares['ab']:.4e} (a-c) {shares['ac']:.4e} "
              f"(b-c) {shares['bc']:.4e} (c-d) {shares['cd']:.4e}")
        for ln, r in block.items():
            print(f"  {ln}: H rank {r['rank']} of {r['size']}, dead "
                  f"{r['dead']}; flips a-b {r['ab']:.4e} a-c {r['ac']:.4e} b-c "
                  f"{r['bc']:.4e} c-d {r['cd']:.4e}; ||(W-W')X||^2 a {r['obj_a']:.6g} "
                  f"b {r['obj_b']:.6g} c {r['obj_c']:.6g} d {r['obj_d']:.6g}")
        assert shares["cd"] <= CD_SHARE, (name, shares)
        assert shares["ab"] <= max(shares["ac"], shares["bc"]), (name, shares)


def test_float64_sweeps_agree_on_the_objective(witness):
    """(c) and (d) reach the same OBS objective within 1e-6 relative, where
    the float32 sweeps may differ by their rounding."""
    for block in witness.values():
        for ln, r in block.items():
            assert abs(r["obj_c"] - r["obj_d"]) <= 1e-6 * max(r["obj_d"], 1e-12), (ln, r)
