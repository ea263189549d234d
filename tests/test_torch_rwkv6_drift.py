"""rwkv6-3b's bf16 decode drift, in both packages: does the port drift
from its own forward more than the reference drifts from its own?

Each package prefills all but the last ``STEPS`` tokens of a prompt,
decodes those one by one, and holds every step's logits (the prefill's
last position too) to its own teacher-forced forward of the whole prompt,
as ``max|d| / max|logits|`` (``chip_smoke.py`` phase 15's decode gate).
Both run the same random init: JAX's ``LM.init``, carried into the port
with ``repro_torch.convert.lm_params_from_jax``, then cast to bf16 in each
package, as phase 15 serves it.  The drift is the two packages' own
rounding order; the reference sets what a bf16 rwkv6 decode drifts by.

The port runs a second time with its products rounded exactly
(:func:`exact_products`: bf16 operands summed in fp64 and rounded once to
bf16), which takes the matmul library's summation order out: on the CPU,
torch's bf16 GEMM rounds a row's result differently by the number of rows
in the call and by its thread count, so a prefill (60 rows) and a forward
(64 rows) of the same tokens part by an ulp in the first layer already.
With exact products the port's prefill gives at its last position what
its forward gives there, as JAX's does, and the rest of the port's bf16 op
order (shift, decay, chunked wkv, norms, cache) is held.

The tests run the smoke config, a narrow deep one and the published width
at 2 layers on the CPU.  The published width runs from the command line
(``--layers`` cuts the depth only), e.g.::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rwkv6_drift.py \\
        --layers 16

At 16 layers the run holds both packages' fp32 params for a moment while
converting (~14 GB) and takes a few minutes.  With ``--device cuda`` it
runs the port alone on the card (no JAX), at full depth unless
``--layers`` says otherwise, from the port's own bf16 init.
"""
import argparse
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, lm, rwkv6

ARCH = "rwkv6-3b"
#: decode steps after the prefill, as phase 15
STEPS = 4


def exact_dense(p, x, compute_dtype=torch.bfloat16, *, split_out=False):
    """``layers.dense`` with its product rounded exactly: the operands in
    ``compute_dtype``, summed in fp64 (exact for bf16 products at these
    depths, bar the last bits) and rounded once.  ``split_out`` is
    ``dense``'s, which only a sharded product uses."""
    y = torch.matmul(x.to(compute_dtype).double(),
                     p["w"].to(compute_dtype).double()).to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


@contextlib.contextmanager
def exact_products():
    """rwkv6's projections and the LM head through :func:`exact_dense`."""
    saved = rwkv6.dense, lm.dense
    rwkv6.dense = lm.dense = exact_dense
    try:
        yield
    finally:
        rwkv6.dense, lm.dense = saved


def _cfgs(smoke, layers=None, **widths):
    """(JAX cfg, port cfg) of rwkv6-3b, smoke or published, with the depth
    and any width replaced."""
    from repro.configs import get_config as jax_get_config

    over = dict(widths)
    if layers is not None:
        over["n_layers"] = layers
    return (dataclasses.replace(jax_get_config(ARCH, smoke=smoke), **over),
            dataclasses.replace(get_config(ARCH, smoke=smoke), **over))


def _bf16_pair(jcfg, tcfg, seed):
    """Both packages' models and bf16 params from one JAX init."""
    import jax
    import jax.numpy as jnp

    from repro.models import build_model as jax_build_model
    from repro_torch.convert import lm_params_from_jax

    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = lm_params_from_jax(jparams, tcfg, device="cpu")

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else
                [cast(b) for b in v] if isinstance(v, list) else
                v.to(torch.bfloat16) for k, v in tree.items()}

    tparams = cast(tparams)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    return jmodel, jparams, build_model(tcfg, device="cpu"), tparams


def _errs(full, steps):
    """max|step - forward| / max|forward| for each (position, logits)."""
    full = np.asarray(full, np.float32)
    scale = float(np.abs(full).max())
    return [float(np.abs(np.asarray(s, np.float32) - full[t]).max()) / scale
            for t, s in steps]


def jax_drift(model, params, prompt):
    """The reference's bf16 prefill-then-decode against its own forward."""
    import jax.numpy as jnp

    n = len(prompt)
    s0 = n - STEPS
    tokens = jnp.asarray(prompt[None])
    full = model.logits(params, tokens)[0].astype(jnp.float32)
    cache = model.init_cache(1, n + 8)
    logits, cache = model.prefill(params, tokens[:, :s0], cache)
    steps = [(s0 - 1, logits[0, -1].astype(jnp.float32))]
    for t in range(s0, n):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        steps.append((t, logits[0, -1].astype(jnp.float32)))
    return _errs(full, steps)


def port_drift(model, params, prompt):
    """The port's bf16 prefill-then-decode against its own forward."""
    n = len(prompt)
    s0 = n - STEPS
    tokens = prompt[None]

    def host(t):
        return t.float().cpu().numpy()

    with torch.no_grad():
        full = host(model.logits(params, tokens)[0])
        cache = model.init_cache(1, n + 8)
        logits, cache = model.prefill(params, tokens[:, :s0], cache)
        steps = [(s0 - 1, host(logits[0, -1]))]
        for t in range(s0, n):
            logits, cache = model.decode_step(params, cache,
                                              tokens[:, t:t + 1])
            steps.append((t, host(logits[0, -1])))
    return _errs(full, steps)


def measure(jcfg, tcfg, seed=0, prompt_len=64):
    """Both packages' per-step drifts on one prompt drawn from ``seed``,
    the port's with its own products and with exact ones."""
    prompt = np.random.default_rng(seed).integers(0, jcfg.vocab,
                                                  size=prompt_len)
    jmodel, jparams, tmodel, tparams = _bf16_pair(jcfg, tcfg, seed)
    terr = port_drift(tmodel, tparams, prompt)
    with exact_products():
        texact = port_drift(tmodel, tparams, prompt)
    return jax_drift(jmodel, jparams, prompt), terr, texact


#: the narrow deep case: rwkv6's structure at 16 layers, 128 wide
DEEP = dict(n_layers=16, d_model=128, n_heads=8, d_head=16, d_ff=448,
            rwkv_head_dim=16)


@pytest.mark.parametrize("widths", [{}, DEEP], ids=["smoke", "deep"])
def test_port_drifts_no_more_than_the_reference(widths):
    """The port's bf16 decode drifts from its own forward by no more than
    twice what the reference's drifts from its own, plus one bf16 ulp of
    the largest logit (2**-8): the two round in other orders, so neither
    drift is the other's."""
    jcfg, tcfg = _cfgs(True, **widths)
    jerr, terr, _ = measure(jcfg, tcfg, seed=3, prompt_len=24)
    assert len(jerr) == len(terr) == STEPS + 1
    assert all(np.isfinite(jerr)) and all(np.isfinite(terr))
    assert max(terr) <= 2 * max(jerr) + 2.0 ** -8, (jerr, terr)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_matches_forward_with_exact_products(seed):
    """At rwkv6-3b's published widths (2 layers, the vocabulary cut to
    512), where torch's CPU GEMM rounds rows by the call's row count: with
    exact products, the port's prefill is no further from its forward at
    the last prefilled position than JAX's is from JAX's, and its decode
    drifts no more than twice JAX's."""
    jcfg, tcfg = _cfgs(False, 2, vocab=512)
    jerr, _, texact = measure(jcfg, tcfg, seed=seed, prompt_len=64)
    assert all(np.isfinite(jerr)) and all(np.isfinite(texact))
    assert texact[0] <= jerr[0], (jerr, texact)
    assert max(texact) <= 2 * max(jerr), (jerr, texact)


def card_drift(layers, seed, prompt_len, device):
    """The port alone on ``device``: its bf16 drift from its own forward,
    with its own products and with exact ones."""
    tcfg = get_config(ARCH)
    if layers is not None:
        tcfg = dataclasses.replace(tcfg, n_layers=layers)
    model = build_model(tcfg, device=device)
    params = model.init(seed, dtype=torch.bfloat16)
    prompt = np.random.default_rng(seed).integers(0, tcfg.vocab,
                                                  size=prompt_len)
    terr = port_drift(model, params, prompt)
    with exact_products():
        texact = port_drift(model, params, prompt)
    return tcfg, terr, texact


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of both models (published: 32; default 16 "
                         "on the CPU, 32 on the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--device", default="cpu",
                    help="cpu: both packages; cuda: the port alone")
    ap.add_argument("--threads", type=int, default=4,
                    help="torch's CPU threads (its GEMM rounds by them)")
    args = ap.parse_args()
    out = {"arch": ARCH, "prompt_len": args.prompt_len, "seed": args.seed,
           "decode_steps": STEPS, "device": args.device}
    if args.device == "cpu":
        torch.set_num_threads(args.threads)
        out["threads"] = args.threads
        jcfg, tcfg = _cfgs(False, 16 if args.layers is None
                           else args.layers)
        jerr, terr, texact = measure(jcfg, tcfg, args.seed, args.prompt_len)
        out.update(jax_drift=jerr, jax_max=max(jerr))
    else:
        tcfg, terr, texact = card_drift(args.layers, args.seed,
                                        args.prompt_len, args.device)
        out["card"] = torch.cuda.get_device_name(0)
    out.update(layers=tcfg.n_layers, d_model=tcfg.d_model, port_drift=terr,
               port_max=max(terr), port_exact_drift=texact,
               port_exact_max=max(texact))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
