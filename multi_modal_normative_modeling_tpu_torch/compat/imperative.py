"""The reference's imperative model classes as torch modules (counterpart
of compat/imperative.py).

Reference users whose own scripts build a model class and drive the torch
training protocol

    model = cVAE_multimodal(input_dim_list=..., hidden_dim=..., ...)
    model.to(DEVICE)
    fwd = model.forward_multimodal(x_list, c_list, combine)
    loss = model.loss_function_multimodal(x_list, fwd)
    model.optimizer1.zero_grad(); loss['total'].backward()
    model.optimizer1.step()

(multimodal_kfold_train_cvae_supervised.py:150-214, nmpmcont:257-315,
regression:103-127) keep that loop verbatim. Each facade is an
``nn.Module`` over the port's one-fold model (``build_model(...,
folds=1)``): its parameters are real ``nn.Parameter``s, the loop runs on
torch's own autograd, and ``optimizer1`` is ``torch.optim.Adam`` at the
constructor's learning rate (eps 1e-8, the JAX facade's optax.adam).

What the facade keeps from the JAX one:
  * ``optimizer1.lr = clr`` is the reference quirk it is (SURVEY Q1): a
    dead attribute on ``torch.optim.Adam``; the step keeps the
    constructor's rate;
  * ``backward()`` works on any loss component, and twice accumulates
    into ``.grad`` until ``zero_grad()`` (the graph is retained);
  * the constructors' defaults (modalities=3, non_linear=False);
  * ``pred_recon`` through the model's plain ``pred_recon`` with a fresh
    draw per call (SURVEY Q2), returning numpy; DataFrames are taken
    wherever arrays are;
  * ``torch.save(model, path)`` / ``torch.load(path)`` round-trip: the
    noise generator's state travels as a tensor.

The parameters live on ``cuda`` unless the constructor is given
``device="cpu"``; ``.to()`` moves them. The noise of the reparameterization
and the dropout masks come from a ``torch.Generator`` seeded 42 that the
facade owns (on the host, so a draw is the same on any device). Forward
outputs stay on the facade's device; the reference's own code calls
``.cpu()`` on them.
"""
from __future__ import annotations

import math
import numpy as np
import torch
from torch import nn

DEVICE = "cuda"  # the `.to(DEVICE)` target of the reference's scripts


def _np_f32(x) -> np.ndarray:
    """numpy float32 of a tensor, a DataFrame or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)
    if hasattr(x, "values") and not isinstance(x, np.ndarray):
        x = x.values
    return np.asarray(x, dtype=np.float32)


def _squeeze(node):
    """Every tensor of a forward's tree without its fold axis."""
    if isinstance(node, dict):
        return {k: _squeeze(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_squeeze(v) for v in node)
    return node[0] if isinstance(node, torch.Tensor) else node


class _LossScalar:
    """One loss entry with the tensor affordances the reference loops use:
    ``.item()``, ``.backward()`` (which retains the graph, so a component
    can be backpropagated twice and accumulate), ``float()``, format."""

    __slots__ = ("_tensor", "_owner", "_state")

    def __init__(self, tensor: torch.Tensor, owner, state=None):
        self._tensor = tensor
        self._owner = owner
        self._state = state

    def item(self) -> float:
        return float(self._tensor.detach().cpu())

    def __float__(self) -> float:
        return self.item()

    def __repr__(self) -> str:
        return repr(self.item())

    def __format__(self, spec) -> str:
        return format(self.item(), spec)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.item(), dtype=dtype)

    def detach(self):
        return self

    def cpu(self):
        return self

    def numpy(self):
        return np.asarray(self.item())

    def backward(self):
        self._tensor.backward(retain_graph=True)
        if self._state is not None:
            self._owner._pending_state = self._state


class _Adam(torch.optim.Adam):
    """``torch.optim.Adam`` whose ``step`` also applies the non-gradient
    state a loss handed back (the end-to-end model's BatchNorm running
    statistics), as the JAX facade's does. Assigning ``lr`` is the dead
    attribute write of the reference (SURVEY Q1)."""

    def __init__(self, owner, params, learning_rate: float):
        super().__init__(params, lr=learning_rate, eps=1e-8)
        self._owner = owner

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none)
        self._owner._pending_state = None

    def step(self, closure=None):
        out = super().step(closure)
        self._owner._apply_state()
        return out

    def __getstate__(self):
        return {**super().__getstate__(), "_owner": self._owner}


class _ImperativeModel(nn.Module):
    """The shared machinery: the one-fold core, its optimizer, the noise
    generator, the pending non-gradient state, pickling."""

    _OPTIMIZER_ATTR = "optimizer1"

    def _setup(self, core: nn.Module, learning_rate: float, device,
               seed: int = 42):
        from ..cli.common import resolve_device

        self.core = core.to(resolve_device(str(device), 'build the model'))
        self._gen = torch.Generator().manual_seed(seed)
        self._pending_state = None
        setattr(self, self._OPTIMIZER_ATTR,
                _Adam(self, self.core.parameters(), float(learning_rate)))

    @property
    def device(self) -> torch.device:
        return next(self.core.parameters()).device

    def _in(self, x) -> torch.Tensor:
        """An input as a [1, B, ...] float32 tensor on the facade's device."""
        if isinstance(x, torch.Tensor):
            t = x.detach().to(torch.float32)
        else:
            t = torch.from_numpy(np.array(_np_f32(x)))
        return t.to(self.device)[None]

    def _draw(self, shape) -> torch.Tensor:
        """Standard normal noise of ``shape`` from the facade's generator."""
        return torch.randn(shape, generator=self._gen).to(self.device)

    def _wrap_losses(self, losses: dict, state=None) -> dict:
        return {k: _LossScalar(v[0], self, state) for k, v in losses.items()}

    def _apply_state(self) -> None:
        self._pending_state = None

    # -- pickling (torch.save(model, path) works) ----------------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_gen"] = self._gen.get_state()
        return state

    def __setstate__(self, state):
        state = dict(state)
        gen_state = state.pop("_gen")
        super().__setstate__(state)
        self._gen = torch.Generator()
        self._gen.set_state(gen_state)


class _MultimodalFacade(_ImperativeModel):
    """Protocol of the six registry classes (train script:150-214):
    forward_multimodal / loss_function_multimodal / optimizer1 /
    pred_recon / reconstruction_deviation_multimodal."""

    _REGISTRY_NAME: str = ""

    def __init__(self, input_dim_list, hidden_dim, latent_dim, c_dim,
                 learning_rate: float = 0.0001, modalities: int = 3,
                 non_linear: bool = False, device=DEVICE, **_ignored):
        # the reference constructor's defaults (cVAE.py:1087-1095)
        super().__init__()
        core = self._build(list(input_dim_list), list(hidden_dim),
                           latent_dim, c_dim, modalities, non_linear)
        self._setup(core, learning_rate, device)
        self.modalities = modalities

    def _build(self, dims, hidden, latent_dim, c_dim, modalities,
               non_linear):
        from ..models import build_model

        return build_model(self._REGISTRY_NAME, dims, hidden, latent_dim,
                           c_dim, modalities, non_linear, folds=1,
                           generator=torch.Generator().manual_seed(42))

    def forward_multimodal(self, x_list, c_list, combine):
        xes = [self._in(x) for x in x_list]
        cs = [self._in(c) for c in c_list]
        eps = self._draw((1, xes[0].shape[1], self.core.noise_dim))
        fwd = self.core(xes, cs, combine, eps=eps)
        out = _squeeze(fwd)
        out["__mmnm_pending__"] = (xes, fwd)
        return out

    @staticmethod
    def _pending(fwd_rtn, what: str):
        token = fwd_rtn.get("__mmnm_pending__") if isinstance(
            fwd_rtn, dict) else None
        if token is None:
            raise ValueError(f"{what} expects the dict returned by this "
                             "model's forward")
        return token

    def loss_function_multimodal(self, x_list, fwd_rtn):
        xes, fwd = self._pending(fwd_rtn, "loss_function_multimodal")
        return self._wrap_losses(self.core.loss(xes, fwd, None))

    def pred_recon(self, xes, c, DEVICE=None, combine="gPoE"):
        """Stochastic test-time reconstruction (cVAE.py:1198-1208; a fresh
        reparameterization draw per call, SURVEY Q2). ``xes`` may be
        DataFrames; ``c`` is the one covariate matrix every modality
        shares. Returns numpy [B, D_m] per modality."""
        xs = [self._in(x) for x in xes]
        cov = self._in(c)
        eps = self._draw((1, xs[0].shape[1], self.core.noise_dim))
        with torch.no_grad():
            recons = self.core.pred_recon(xs, [cov] * len(xs), combine,
                                          eps=eps)
        return [r[0].cpu().numpy() for r in recons]

    def reconstruction_deviation_multimodal(self, xes, x_preds):
        """Per-modality per-subject mean squared error (cVAE.py:1210-1212)."""
        return [np.sum((_np_f32(xes[m]) - _np_f32(x_preds[m])) ** 2, axis=1)
                / _np_f32(xes[m]).shape[1] for m in range(self.modalities)]


class cVAE_multimodal(_MultimodalFacade):
    _REGISTRY_NAME = "cVAE_multimodal"


class mmJSD(_MultimodalFacade):
    _REGISTRY_NAME = "mmJSD"


class DMVAE(_MultimodalFacade):
    _REGISTRY_NAME = "DMVAE"


class WeightedDMVAE(_MultimodalFacade):
    _REGISTRY_NAME = "WeightedDMVAE"


class mvtCAE(_MultimodalFacade):
    _REGISTRY_NAME = "mvtCAE"


class mmVAEPlus(_MultimodalFacade):
    _REGISTRY_NAME = "mmVAEPlus"


class cVAE_multimodal_endtoend(_ImperativeModel):
    """nm-PM-cont protocol (nmpmcont:257-315): forward / loss_function /
    optimizer (not optimizer1) / predict; dual decoder banks, classifier
    and margin-contrastive loss (models/endtoend.py, cVAE.py:2021-2207).
    The BatchNorm running statistics of a training forward are written
    after ``optimizer.step()``."""

    _OPTIMIZER_ATTR = "optimizer"

    def __init__(self, input_dim_list, hidden_dim, latent_dim, c_dim,
                 learning_rate: float = 0.0001, modalities: int = 3,
                 non_linear: bool = False, classifier_layers=(128, 64),
                 dropout_rate: float = 0.5, num_classes: int = 2,
                 device=DEVICE, **_ignored):
        # the reference constructor's defaults (cVAE.py:2021-2032)
        from ..models.endtoend import EndToEndCVAE

        super().__init__()
        core = EndToEndCVAE(list(input_dim_list), list(hidden_dim),
                            latent_dim, c_dim, modalities, non_linear,
                            classifier_layers=list(classifier_layers),
                            dropout_rate=dropout_rate,
                            num_classes=num_classes, folds=1,
                            generator=torch.Generator().manual_seed(42))
        self._setup(core, learning_rate, device)
        self.modalities = modalities

    def forward(self, x_list, c_list):
        xes = [self._in(x) for x in x_list]
        cs = [self._in(c) for c in c_list]
        rows = xes[0].shape[1]
        eps = self._draw((1, rows, self.core.noise_dim))
        keep = None
        if self.training and self.core.keep_widths:
            keep = [torch.rand((1, rows, w), generator=self._gen).to(
                self.device) < 1.0 - self.core.dropout_rate
                for w in self.core.keep_widths]
        fwd = self.core(xes, cs, eps, train=self.training, keep=keep)
        out = _squeeze({k: v for k, v in fwd.items() if k != "bn_state"})
        out["__mmnm_pending__"] = (xes, fwd)
        return out

    def loss_function(self, x_list, fwd_rtn, labels, margin=1.0,
                      weight_contrastive=0.1):
        xes, fwd = _MultimodalFacade._pending(fwd_rtn, "loss_function")
        lab = torch.as_tensor(np.asarray(
            labels.detach().cpu().numpy() if hasattr(labels, "detach")
            else labels).reshape(1, -1), device=self.device)
        losses = self.core.loss(xes, fwd, lab, float(margin),
                                float(weight_contrastive))
        state = fwd["bn_state"] if self.training else None
        return self._wrap_losses(losses, state)

    def _apply_state(self) -> None:
        if self._pending_state is not None:
            self.core.classifier.update_state(
                self._pending_state, torch.ones(1, device=self.device))
        self._pending_state = None

    def predict(self, x_list, c_list):
        """Eval-mode classifier logits [B, classes] from the fused mean
        (cVAE.py:2202)."""
        xes = [self._in(x) for x in x_list]
        cs = [self._in(c) for c in c_list]
        return self.core.predict(xes, cs)[0]


class _Normal:
    """The part of torch.distributions.Normal the reference's scripts use
    (loc / scale / mean / log_prob / sample)."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    @property
    def mean(self):
        return self.loc

    def log_prob(self, x):
        var = self.scale * self.scale
        log_scale = (self.scale.log() if hasattr(self.scale, "log")
                     else np.log(self.scale))
        return (-((x - self.loc) ** 2) / (2 * var) - log_scale
                - 0.5 * math.log(2 * math.pi))

    def sample(self):
        if hasattr(self.loc, "detach"):
            return self.loc + self.scale * torch.randn_like(self.loc)
        return self.loc + self.scale * np.random.standard_normal(
            np.shape(self.loc)).astype(np.float32)


Normal = _Normal


class cVAE_multimodal_regression(_MultimodalFacade):
    """FI-regression protocol (regression script:103-190): the multimodal
    protocol plus a fi_target/lambda_reg loss and the single-modality
    encode/reparameterise/decode eval path (models/regression.py,
    cVAE.py:2211-2346)."""

    def _build(self, dims, hidden, latent_dim, c_dim, modalities,
               non_linear):
        from ..models.regression import RegressionCVAE

        return RegressionCVAE(dims, hidden, latent_dim, c_dim, modalities,
                              non_linear, folds=1,
                              generator=torch.Generator().manual_seed(42))

    def loss_function_multimodal(self, x_list, fwd_rtn, fi_target,
                                 lambda_reg=1.0):
        xes, fwd = self._pending(fwd_rtn, "loss_function_multimodal")
        fi = self._in(_np_f32(fi_target).reshape(-1))
        return self._wrap_losses(self.core.loss(xes, fwd, fi,
                                                float(lambda_reg)))

    # the single-modality eval path (regression script:183-188)
    def encode(self, x, c, modal_idx: int):
        mu, logvar = self.core.enc[modal_idx](self._in(x), self._in(c))
        return mu[0], logvar[0]

    def reparameterise(self, mu, logvar):
        eps = self._draw(tuple(mu.shape))
        return mu + eps * torch.exp(0.5 * logvar)

    def decode(self, z, c, modal_idx: int):
        mean, logvar_out = self.core.dec[modal_idx](self._in(z), self._in(c))
        return _Normal(mean[0], torch.exp(0.5 * logvar_out[0]))


# -- module-level ops the reference exports (cVAE.py:14, :113, :986-1083) ----

def _run_fusion(fn, *arrays):
    args = [torch.from_numpy(np.array(_np_f32(a))) for a in arrays]
    return tuple(fn(*args))


class ProductOfExperts:
    """cVAE.py:986-998: returns (mu, var), the var labelled 'logvar' by the
    reference (Q3, reproduced as the same values)."""

    def __call__(self, mu, var):
        from ..ops import fusion

        return _run_fusion(fusion.product_of_experts, mu, var)

    forward = __call__


class ProductOfExperts2:
    """cVAE.py:1482-1489: PoE over (mu, logvar)."""

    def __call__(self, mu, logvar):
        from ..ops import fusion

        return _run_fusion(fusion.poe_logvar, mu, logvar)

    forward = __call__


class MixtureOfExperts:
    """cVAE.py:1000-1011: uniform-weight arithmetic mean of mu and var."""

    def __call__(self, mus, variances):
        from ..ops import fusion

        return _run_fusion(fusion.mixture_of_experts, mus, variances)

    forward = __call__


class MoPoE:
    """cVAE.py:1060-1083: PoE appended as an extra expert, then MoE."""

    def __call__(self, mus, variances):
        from ..ops import fusion

        return _run_fusion(fusion.mixture_of_product_of_experts, mus,
                           variances)

    forward = __call__


def compute_ll(x, x_recon):
    """cVAE.py:14-15: Gaussian log-likelihood summed over features, meaned
    over the batch. ``x_recon`` is a Normal-like with ``.log_prob``."""
    lp = x_recon.log_prob(x)
    if hasattr(lp, "detach"):
        return lp.sum(dim=1, keepdim=True).mean(0)
    lp = np.asarray(lp)
    return lp.sum(axis=1, keepdims=True).mean(axis=0)


class FocalLoss:
    """cVAE.py:113-138 (the legacy discriminator objective)."""

    def __init__(self, alpha=0.25, gamma=2.0, logits=True, reduce=True):
        self.alpha = alpha
        self.gamma = gamma
        self.logits = logits
        self.reduce = reduce

    def __call__(self, inputs, targets):
        from ..ops.losses import focal_loss

        return focal_loss(torch.from_numpy(np.array(_np_f32(inputs))),
                          torch.from_numpy(np.array(_np_f32(targets))),
                          self.alpha, self.gamma, logits=self.logits,
                          reduction="mean" if self.reduce else "none")

    forward = __call__
