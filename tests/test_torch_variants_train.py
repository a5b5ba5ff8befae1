"""The port's train step with each optimizer variant against the
reference's on the reduced smollm-360m: 5 steps from the same parameters
(the reference's init carried over as numpy) on the same batches.

Tolerances as ``tests/test_torch_train.py``'s trajectory test: each step's
loss 1e-4 and the loss_ema atol 1e-3.  MuonBP runs with period 2, so the
steps alternate refresh and reuse; Dion2 starts cold and then warms.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core.muon import MuonConfig  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.train_state import TrainState  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


@pytest.mark.parametrize("variant", ["normuon", "muonbp", "dion2",
                                     "adamuon"])
def test_loss_ema_trajectory_matches_reference(variant):
    jcfg = jconfigs.get("smollm-360m", reduced=True)
    tcfg = tconfigs.get("smollm-360m", reduced=True)
    jparams = jtransformer.init(jcfg, jax.random.PRNGKey(0))
    tparams = ttransformer.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu", requires_grad=True)
    mcfg = dict(variant=variant, learning_rate=0.02, momentum=0.95,
                muonbp_period=2)
    jopt = japi.Muon(japi.dedicate_params(jparams),
                     config=JMuonConfig(**mcfg))
    topt = tapi.Muon(tapi.dedicate_params(tparams),
                     config=MuonConfig(**mcfg), device="cpu")
    jstate = JTrainState(jnp.zeros((), jnp.int32), jparams,
                         jopt.init(jparams), jnp.zeros((), jnp.float32))
    tstate = TrainState(0, tparams, topt.init(tparams),
                        torch.zeros((), dtype=torch.float32))
    assert tstate.opt_state.variant_state is not None
    jfn = jstep.make_train_step(jcfg, jopt, donate=False)
    tfn = tstep.make_train_step(tcfg, topt, device="cpu")
    jloss_fn, tloss_fn = jstep.make_loss_fn(jcfg), tstep.make_loss_fn(tcfg)
    dcfg = tpipeline.DataConfig(vocab=tcfg.vocab, seq_len=32, global_batch=4)
    for i in range(5):
        jbatch = jpipeline.batch_for_step(dcfg, i)
        tbatch = tpipeline.batch_for_step(dcfg, i, device="cpu")
        with torch.no_grad():
            tloss = float(tloss_fn(tstate.params, tbatch))
        np.testing.assert_allclose(tloss, float(jloss_fn(jstate.params,
                                                         jbatch)),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        jstate = jfn(jstate, jbatch)
        tstate = tfn(tstate, tbatch)
        np.testing.assert_allclose(float(tstate.loss_ema),
                                   float(jstate.loss_ema), rtol=0, atol=1e-3,
                                   err_msg=f"step {i}")
    assert tstate.step == int(jstate.step) == 5
    assert tstate.opt_state.step == 5
