"""The subgraph convs' dense models trained against the JAX package, on
the CPU: a four-step AdamW trajectory of ``make_ma_model(conv,
device="cpu")`` for SSWL, DSSGNN, GNNAK and SUN in DD mode, and of
SSWL-SD on the fused route, with every gradient of the first step, from
the JAX weights carried across by ``weights.load_jax_params``.  Their
predictions, ``remat`` and serving:
``tests/test_torch_dense_subgraph_models.py``.

Models of 2 layers x 16 on 16 ``synthetic_zinc`` graphs in shuffled
batches of 8 (n padded to 32), with the settings of the convs' dense rows
(``test_torch_dense_subgraph_models.KW``).
"""

import numpy as np
import pytest
from flax import nnx

from pygho_tpu.hodata.ma_data import batch_to_dense_dict as jx_to_dict
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch.honn import parse_spmamm_dims
from pygho_tpu_torch.models import make_dense_steps, make_optimizer
from test_torch_dense_subgraph_models import (  # noqa: F401
    CONVS, _loaders, _models, one_torch_thread)
from test_torch_subgraph_convs import (_port_name, bn_fed_biases,
                                       jax_params, maxrel)


@pytest.mark.parametrize("conv,mode,route", [
    *[(conv, "DD", None) for conv in CONVS], ("SSWL", "SD", "fused")])
def test_dense_training_matches_jax(conv, mode, route):
    """Four AdamW steps at lr 1e-3 through the port's ``make_dense_steps``
    and the body of the JAX package's (its ``nnx.value_and_grad`` and
    ``optimizer.update``, returning the gradients as well), from the same
    weights, on shuffled batches of 8 of 16 graphs: DD for each conv, and
    SSWL-SD on the fused route (K1's three roles on both plan keys).

    - The first step's gradients: every parameter's (the edge
      embedding's among them, which for SSWL flows through the
      cross-subgraph product's dX role too) within 2e-4 of its largest
      entry (sums in other orders through two layers' forward and
      backward); the biases that feed a BatchNorm are left out, their
      gradients being rounding noise on both sides.
    - Per-step losses: 1e-5 relative.
    - Final parameters and BatchNorm statistics: within 2 * steps * 1.05
      * lr abs (AdamW's largest move where a gradient is rounding noise,
      ``tests/test_torch_subgraph_models.py``'s bound), and all but 1 in
      1,000 elements of each tensor but those biases within 1e-5 abs +
      1e-5 relative.  A parameter that JAX's run moves must move in the
      port's."""
    STEPS, LR = 4, 1e-3
    plans = route == "fused"
    jm, pm = _models(conv, mode)
    start = jax_params(jm)
    dims = parse_spmamm_dims(pm)
    jdl, pdl = _loaders(mode, plans, dims, "train", 16, shuffle=True,
                        drop_last=True, seed=3)
    jopt = jx_training.make_optimizer(jm, LR)
    pstep, _ = make_dense_steps()
    popt = make_optimizer(pm, LR)
    jm.train()
    pm.train()

    @nnx.jit
    def jstep(model, optimizer, batch):
        def loss_fn(model):
            pred = model(jx_to_dict(batch))
            return jx_training.masked_l1_loss(pred, batch["y"],
                                              batch["graph_mask"])

        loss, grads = nnx.value_and_grad(loss_fn)(model)
        optimizer.update(model, grads)
        return loss, grads

    def batches(dl):
        while True:
            yield from dl

    params = dict(pm.named_parameters())
    noisy = bn_fed_biases(pm)
    jl, pl = [], []
    for i, jb, pb in zip(range(STEPS), batches(jdl), batches(pdl)):
        loss, jg = jstep(jm, jopt, jb)
        jl.append(float(loss))
        pl.append(float(pstep(pm, popt, pb)))
        if i:
            continue
        checked = set()
        for path, g in nnx.to_flat_state(jg):
            name, transpose = _port_name(path)
            if name in noisy:
                continue
            g = np.asarray(g.get_value())
            g = g.T if transpose else g
            grad = params[name].grad
            if grad is None:      # a parameter the model does not use
                assert not np.any(g), name
                continue
            assert maxrel(grad.numpy(), g) < 2e-4, name
            checked.add(name)
        assert "data_encoder.ea_encoder.weight" in checked
        assert np.abs(params["data_encoder.ea_encoder.weight"].grad
                      .numpy()).max() > 0
        assert len(checked) > len(params) // 2
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-5 * np.abs(jl)), (pl, jl)

    targets = dict(params)
    targets.update(pm.named_buffers())
    checked = set()
    for path, ref in jax_params(jm).items():
        name, transpose = _port_name(path)
        got = targets[name].detach().numpy()
        ref = ref.T if transpose else ref
        init = start[path].T if transpose else start[path]
        if name in params and not np.array_equal(ref, init):
            assert not np.array_equal(got, init), f"{name} is stuck"
        assert np.abs(got - ref).max() <= 2 * STEPS * 1.05 * LR, name
        if name not in noisy:
            off = ~np.isclose(got, ref, rtol=1e-5, atol=1e-5)
            assert off.sum() <= off.size // 1000, name
        checked.add(name)
    assert checked == set(targets)
