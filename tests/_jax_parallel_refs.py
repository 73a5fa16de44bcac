"""JAX references of the port's sharded tests: the JAX package's sharded
functions on a 2-device CPU mesh, from the inputs the port's ranks
(``tests/_torch_dist_ranks.py``) take. Imported by the test files only."""
import jax
import jax.numpy as jnp
import numpy as np
import optax

from sigsvgd_tpu.controllers import DuSt as JDuSt
from sigsvgd_tpu.inference import MPF as JMPF
from sigsvgd_tpu.inference import SVGD as JSVGD
from sigsvgd_tpu.inference import GaussianLikelihood as JGaussianLikelihood
from sigsvgd_tpu.inference import ScoreResult as JScoreResult
from sigsvgd_tpu.kernels import GaussianKernel as JGaussianKernel
from sigsvgd_tpu.kernels import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.models import ParticleModel as JParticleModel
from sigsvgd_tpu.models import PendulumModel as JPendulumModel
from sigsvgd_tpu.parallel import sharded_mpf_observe as j_mpf
from sigsvgd_tpu.parallel.dust import sharded_dust_forward as j_dust
from sigsvgd_tpu.parallel.mesh import make_mesh as j_make_mesh
from sigsvgd_tpu.parallel.svgd import sharded_pathsig_score as j_pathsig
from sigsvgd_tpu.parallel.svgd import sharded_svgd_run as j_svgd

STATE = [float(np.pi), 0.0]
SIG2 = dict(dyadic_order=2, bandwidth=2.0)
_MODES = dict(hz_len=8, n_pol=16, kernel_mode="signature", adam=0.1, sig=SIG2)
DUST = {
    # name: (port controller, JAX signature kernel, gram mode, opt steps)
    "gather": (_MODES, SIG2, "gather", 2),
    "ring": (_MODES, SIG2, "ring", 2),
    "triangle": (_MODES, SIG2, "triangle", 2),
    "lambda0_tiles": (dict(hz_len=12, n_pol=48, kernel_mode="signature", lr=0.05,
                           sig=dict(dyadic_order=0, bandwidth=4.0)),
                      dict(dyadic_order=0, bandwidth=4.0, solver="pallas_small"),
                      "triangle", 1),
    "lambda3_tiles": (dict(hz_len=8, n_pol=32, kernel_mode="signature", lr=0.05,
                           sig=dict(dyadic_order=3, bandwidth=4.0, solver="pallas")),
                      dict(dyadic_order=3, bandwidth=4.0, solver="pallas"), "triangle", 1),
}
SVGD_STEPS = {"svgd_rbf": 20, "svgd_pathsig": 10}


def pol0(n, hz):
    return np.random.default_rng(11).uniform(-2.0, 2.0, (n, hz, 1)).astype(np.float32)


def svgd_x0():
    rng = np.random.default_rng(3)
    return {"svgd_rbf": (rng.standard_normal((64, 2)) + 2.0).astype(np.float32),
            "svgd_pathsig": (rng.standard_normal((16, 4, 2)) * 0.5).astype(np.float32)}


def mpf_particles():
    return (1.0 + 0.2 * np.random.default_rng(0).standard_normal((40, 1))).astype(np.float32)


def dust_case(name):
    ctrl, _, mode, steps = DUST[name]
    return (name, "case_dust", dict(ctrl=ctrl, opt_steps=steps, modes=[mode], state=STATE,
                                    pol0=pol0(ctrl["n_pol"], ctrl["hz_len"]), single=False))


def svgd_case(name):
    return (name, "case_svgd", dict(score=name[5:], adam=name == "svgd_rbf",
                                    x0=svgd_x0()[name], steps=SVGD_STEPS[name]))


def mpf_case(bw):
    return (f"mpf_{bw}", "case_mpf", dict(bw=bw, particles=mpf_particles(), n_steps=10))


def _mesh():
    return j_make_mesh([2], ("dp",), devices=jax.devices()[:2])


def jax_dust(name):
    """``(a_seq, pol_mean)`` of the JAX sharded solve of ``DUST[name]``."""
    ctrl, sig, mode, steps = DUST[name]
    key = jax.random.PRNGKey(0)
    model = JPendulumModel(dt=0.05)
    adam = ctrl.get("adam")
    jctrl = JDuSt(model=model, hz_len=ctrl["hz_len"], n_pol=ctrl["n_pol"],
                  kernel_mode="signature", kernel=JGaussianKernel(),
                  sig_kernel=JSignatureKernel(**sig),
                  optimizer=optax.adam(adam) if adam else None,
                  lr=ctrl.get("lr", 0.1), inst_cost_fn=model.swingup_inst_cost,
                  term_cost_fn=model.swingup_term_cost)
    cs = jctrl.init(key, pol_mean=jnp.asarray(pol0(ctrl["n_pol"], ctrl["hz_len"])))
    a, cs = j_dust(jctrl, jnp.asarray(STATE), cs, key, steps, _mesh(), gram_mode=mode)
    return np.asarray(a), np.asarray(cs.pol_mean)


def jax_svgd(name):
    key = jax.random.PRNGKey(0)
    x0 = jnp.asarray(svgd_x0()[name])
    if name == "svgd_rbf":
        def quad(x, key):
            return JScoreResult(grad_log_p=-x)

        svgd, score = JSVGD(kernel=JGaussianKernel(), optimizer=optax.adam(0.1)), quad
    else:
        target = jnp.asarray([1.0, 1.0])

        def cost_fn(x):
            return (jnp.sum((x[:, -1, :] - target) ** 2, axis=-1)
                    + 0.1 * jnp.sum(x**2, axis=(1, 2))), {}

        svgd = JSVGD(optimizer=None, lr=0.05)
        score = j_pathsig(cost_fn, JSignatureKernel(dyadic_order=1, bandwidth=2.0))
    x, _ = j_svgd(svgd, x0, score, SVGD_STEPS[name], _mesh(), key=key)
    return np.asarray(x)


def jax_mpf(bw):
    """``(particles, norms, prior_bw)`` of one JAX sharded observe-update."""
    pm = JParticleModel.create(dt=0.1, mass=2.0, control_type="acceleration",
                               map_size=(10, 10), map_cell_size=0.5, max_speed=50.0)
    lik = JGaussianLikelihood(step_fn=pm.step, params_to_dict=pm.params_to_dict,
                              obs_std=0.05)
    state = jnp.zeros(4)
    action = jnp.asarray([1.0, -0.5])
    nxt = pm.step(state[None], action[None])[0]
    mpf = JMPF(likelihood=lik, kernel=JGaussianKernel(), lr=0.05, bw=bw)
    st = mpf.init(jnp.asarray(mpf_particles()), state)
    new, grads = j_mpf(mpf, st, action, nxt, _mesh(), n_steps=10)
    return np.asarray(new.particles), np.asarray(grads), np.asarray(new.prior_bw)


def check_dust(port_out, name, want):
    got = port_out[DUST[name][2]][0]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-3, atol=2e-4)
