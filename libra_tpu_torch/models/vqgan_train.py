"""VQGAN tokenizer training: LPIPS, the PatchGAN discriminator, the VQGAN
losses and ``VQGANTrainer``, as in ``libra_tpu/models/vqgan_train.py``.

* LPIPS: VGG16's five ReLU taps, each unit-normalized over channels,
  their squared difference through a learned 1x1 "lin" head, averaged
  over space and summed over taps. Weights convert from torch checkpoints
  (``checkpoint.convert_vgg16_lpips``); a random init otherwise, which
  only exercises the math.
* The PatchGAN NLayerDiscriminator with batch-statistics BatchNorm (GAN
  training always runs in batch mode; there are no running statistics).
* The generator loss: L1 + perceptual + the adaptive-weight GAN term,
  d_weight = |grad nll| / (|grad g| + 1e-4) on the decoder's last conv
  weight, plus LFQ's aux loss; the hinge or vanilla discriminator loss.
* ``VQGANTrainer``: one autoencoder update (the decoder, the quant and
  post-quant convs; CLIP stays frozen), then one discriminator update on
  a reconstruction by the updated autoencoder, each through AdamW(0.5,
  0.9) with weight decay on every leaf (``optax.adamw``'s).

Activations are NHWC and conv weights HWIO, as in the JAX package; the
trees carry the JAX key paths.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import clip as clip_model
from libra_tpu_torch.models import vqgan as vq
from libra_tpu_torch.ops.conv import conv2d
from libra_tpu_torch.training.optimizer import (adam_leaf_update, bias_corrections,
                                                leaves_with_paths)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# VGG16 / LPIPS
# ---------------------------------------------------------------------------

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
# LPIPS taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (conv indices)
_TAP_AFTER = {1, 3, 6, 9, 12}
_LPIPS_CHANNELS = [64, 128, 256, 512, 512]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_vgg16_params(gen: torch.Generator, device="cuda") -> Params:
    """13 convs, N(0, 1 / fan_in) weights and zero biases, fp32. `gen`
    must live on `device`."""
    convs, cin = [], 3
    for c in _VGG_CFG:
        if c == "M":
            continue
        w = torch.randn((3, 3, cin, c), generator=gen, device=device) * (9 * cin) ** -0.5
        convs.append({"w": w, "b": torch.zeros((c,), device=device)})
        cin = c
    return {"convs": convs}


def _max_pool2(h: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling of NHWC h, an odd last row or column dropped (torch
    MaxPool2d floors); ties share the gradient, as JAX's max does."""
    B, H, W, C = h.shape
    h = h[:, :H // 2 * 2, :W // 2 * 2]
    return h.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def vgg16_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3) in [-1, 1] -> the 5 tapped feature maps."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    h = (x - shift) / scale
    feats, ci = [], 0
    for c in _VGG_CFG:
        if c == "M":
            h = _max_pool2(h)
            continue
        h = torch.relu(conv2d(h, **params["convs"][ci]))
        if ci in _TAP_AFTER:
            feats.append(h)
        ci += 1
    return feats


def init_lpips_params(gen: torch.Generator, device="cuda") -> Params:
    """VGG16 and the five lin heads |N(0, 1)| * 0.1, fp32."""
    vgg = init_vgg16_params(gen, device)
    return {"vgg": vgg,
            "lins": [{"w": torch.randn((1, 1, c, 1), generator=gen, device=device).abs() * 0.1}
                     for c in _LPIPS_CHANNELS]}


def _unit(f: torch.Tensor) -> torch.Tensor:
    """f over its channels' norm: f * rsqrt(sum f^2 + 1e-10)."""
    return f * torch.rsqrt((f * f).sum(dim=-1, keepdim=True) + 1e-10)


def lpips(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The batch mean of the perceptual distance between x and y (B, H,
    W, 3) in [-1, 1]. Each goes through VGG16 on its own, so that autograd
    tracks only the one that needs a gradient."""
    total = 0.0
    for a, b, lin in zip(vgg16_features(params["vgg"], x),
                         vgg16_features(params["vgg"], y), params["lins"]):
        d = (_unit(a) - _unit(b)) ** 2
        val = d @ lin["w"][0, 0]                          # the 1x1 head: (B, H, W, 1)
        total = total + val.mean(dim=(1, 2, 3))           # spatial mean
    return total.mean()


# ---------------------------------------------------------------------------
# PatchGAN discriminator
# ---------------------------------------------------------------------------

def init_discriminator_params(gen: torch.Generator, input_nc: int = 3, ndf: int = 64,
                              n_layers: int = 3, device="cuda") -> Params:
    """NLayerDiscriminator: 4x4 convs N(0, 0.02) with zero biases, a
    BatchNorm (unit scale, zero bias) after every conv but the first, and
    a one-channel 4x4 head. `gen` must live on `device`."""
    def conv(cin, cout):
        return {"w": 0.02 * torch.randn((4, 4, cin, cout), generator=gen, device=device),
                "b": torch.zeros((cout,), device=device)}

    layers: List[Params] = [{"conv": conv(input_nc, ndf), "bn": None}]
    cin = ndf
    for n in range(1, n_layers + 1):
        cout = ndf * min(2 ** n, 8)
        layers.append({"conv": conv(cin, cout),
                       "bn": {"scale": torch.ones((cout,), device=device),
                              "bias": torch.zeros((cout,), device=device)}})
        cin = cout
    return {"layers": layers, "head": conv(cin, 1)}


def _batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (B, H, W) with the batch's statistics: the
    population variance (jnp.var's), no running statistics."""
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    centred = x - mean
    var = (centred * centred).mean(dim=(0, 1, 2), keepdim=True)
    return centred * torch.rsqrt(var + eps) * scale + bias


def _pad1(h: torch.Tensor) -> torch.Tensor:
    """Pad H and W of NHWC h by 1 on each side (torch's padding=1)."""
    return F.pad(h, (0, 0, 1, 1, 1, 1))


def discriminator_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The PatchGAN logits map (B, h, w, 1): every conv pads by 1 and runs
    VALID, stride 2 for the first n_layers convs and 1 after; LeakyReLU
    0.2 after each layer but the head."""
    n_layers = len(params["layers"]) - 1
    h = x
    for i, layer in enumerate(params["layers"]):
        h = conv2d(_pad1(h), **layer["conv"], stride=2 if i < n_layers else 1,
                   padding="VALID")
        if layer["bn"] is not None:
            h = _batch_norm(h, **layer["bn"])
        h = F.leaky_relu(h, 0.2)
    return conv2d(_pad1(h), **params["head"], stride=1, padding="VALID")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.relu(1.0 - logits_real).mean() + torch.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """`value` before step `threshold`, `weight` from it on."""
    return value if global_step < threshold else weight


class VQGANLossConfig(NamedTuple):
    disc_start: int = 0
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    disc_loss: str = "hinge"


def _nll_and_g(loss_params: Params, cfg: VQGANLossConfig, inputs: torch.Tensor,
               recons: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The AE side's reconstruction loss (L1 + perceptual) and GAN loss
    (minus the discriminator's mean logit on the reconstruction)."""
    nll = (inputs - recons).abs().mean()
    if cfg.perceptual_weight > 0:
        nll = nll + cfg.perceptual_weight * lpips(loss_params["lpips"], inputs, recons)
    g_loss = -discriminator_forward(loss_params["disc"], recons).mean()
    return nll, g_loss


def _generator_total(cfg: VQGANLossConfig, nll: torch.Tensor, g_loss: torch.Tensor,
                     codebook_loss: torch.Tensor, global_step: int,
                     nll_grad_last: torch.Tensor, g_grad_last: torch.Tensor):
    """The AE loss from its terms, with the adaptive weight of the GAN
    term from the two gradients on the decoder's last conv weight."""
    d_weight = torch.linalg.vector_norm(nll_grad_last) / (
        torch.linalg.vector_norm(g_grad_last) + 1e-4)
    d_weight = d_weight.clamp(0.0, 1e4).detach() * cfg.disc_weight
    disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
    quant_loss = codebook_loss.mean()
    total = nll + d_weight * disc_factor * g_loss + cfg.codebook_weight * quant_loss
    return total, {"nll_loss": nll, "g_loss": g_loss, "d_weight": d_weight,
                   "quant_loss": quant_loss}


def generator_loss(loss_params: Params, cfg: VQGANLossConfig, codebook_loss, inputs,
                   recons, global_step, nll_grad_last, g_grad_last):
    """The AE-side loss (optimizer_idx 0) and its logs. nll_grad_last /
    g_grad_last: the gradients of the nll and GAN terms on the decoder's
    last conv weight, for the adaptive discriminator weight."""
    nll, g_loss = _nll_and_g(loss_params, cfg, inputs, recons)
    return _generator_total(cfg, nll, g_loss, codebook_loss, global_step,
                            nll_grad_last, g_grad_last)


def discriminator_loss(loss_params: Params, cfg: VQGANLossConfig, inputs, recons,
                       global_step):
    """The discriminator's loss (optimizer_idx 1) on detached inputs and
    reconstructions, and its logs."""
    logits_real = discriminator_forward(loss_params["disc"], inputs.detach())
    logits_fake = discriminator_forward(loss_params["disc"], recons.detach())
    fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
    d = disc_factor * fn(logits_real, logits_fake)
    return d, {"disc_loss": d, "logits_real": logits_real.mean(),
               "logits_fake": logits_fake.mean()}


# ---------------------------------------------------------------------------
# The tokenizer trainer
# ---------------------------------------------------------------------------

# libra_tpu's optax.adamw(lr, b1=0.5, b2=0.9): optax's default decay
_B1, _B2, _WEIGHT_DECAY = 0.5, 0.9, 1e-4


class _AdamW:
    """optax.adamw(lr, 0.5, 0.9): eps 1e-8, weight decay 1e-4 on every
    leaf, a constant learning rate, no clipping. Holds the moments of a
    fixed list of leaves; `step` updates the leaves in place."""

    def __init__(self, leaves: List[torch.Tensor], lr: float):
        self.lr = lr
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        self.count += 1
        c = bias_corrections(_B1, _B2, self.count)
        for w, g, mu, nu in zip(leaves, grads, self.mu, self.nu):
            adam_leaf_update(w, g, mu, nu, _B1, _B2, c, -self.lr, _WEIGHT_DECAY)


_AE_KEYS = ("decoder", "quant_conv", "post_quant_conv")


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree, in leaves_with_paths' order."""
    return [t for _, t in leaves_with_paths(tree)]


class VQGANTrainer:
    """Alternating autoencoder / discriminator training of the tokenizer.
    The CLIP encoder is frozen: the AE side trains the decoder and the
    quant and post-quant convs. `params` lives on `device`; the LPIPS
    (random unless `lpips_params` is given) and discriminator trees are
    made there from `seed`. Parameters are updated in place."""

    def __init__(self, cfg: VQGANConfig, params: Params,
                 loss_cfg: VQGANLossConfig = VQGANLossConfig(), lr: float = 4.5e-6,
                 seed: int = 0, lpips_params: Optional[Params] = None, device="cuda"):
        self.cfg = cfg
        self.loss_cfg = loss_cfg
        self.device = torch.device(device)
        self.params = params
        gen = torch.Generator(device=self.device).manual_seed(seed)
        disc = init_discriminator_params(gen, device=self.device)
        self.loss_params = {
            "lpips": lpips_params if lpips_params is not None
            else init_lpips_params(gen, self.device),
            "disc": disc}
        self.ae_opt = _AdamW(self._ae_leaves(), lr)
        self.disc_opt = _AdamW(_leaves(disc), lr)
        self.step = 0

    def _ae_leaves(self) -> List[torch.Tensor]:
        return _leaves({k: self.params[k] for k in _AE_KEYS})

    def _reconstruct(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """CLIP features -> quant conv, LFQ (training) -> post-quant conv ->
        decoder: (reconstruction, LFQ's aux loss)."""
        out = vq.quantize_features(self.params, self.cfg, feat, training=True)
        z = conv2d(out.quantized, **self.params["post_quant_conv"])
        return vq.decoder_forward(self.params["decoder"], self.cfg, z), out.aux_loss

    def _ae_step(self, feat: torch.Tensor, targets: torch.Tensor):
        leaves = self._ae_leaves()
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                recon, aux = self._reconstruct(feat)
                nll, g_loss = _nll_and_g(self.loss_params, self.loss_cfg, targets, recon)
                # both adaptive-weight gradients on the one graph (taming's
                # calculate_adaptive_weight), then the total's
                w_last = self.params["decoder"]["conv_out"]["w"]
                nll_grad, = torch.autograd.grad(nll, w_last, retain_graph=True)
                g_grad, = torch.autograd.grad(g_loss, w_last, retain_graph=True)
                total, logs = _generator_total(self.loss_cfg, nll, g_loss, aux, self.step,
                                               nll_grad, g_grad)
                grads = torch.autograd.grad(total, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        self.ae_opt.step(leaves, grads)
        return total.detach(), {k: v.detach() for k, v in logs.items()}

    def _disc_step(self, feat: torch.Tensor, targets: torch.Tensor):
        with torch.no_grad():
            recon, _ = self._reconstruct(feat)
        leaves = _leaves(self.loss_params["disc"])
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                d, logs = discriminator_loss(self.loss_params, self.loss_cfg, targets, recon,
                                             self.step)
                grads = torch.autograd.grad(d, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        self.disc_opt.step(leaves, grads)
        return d.detach(), {k: v.detach() for k, v in logs.items()}

    def train_step(self, pixels, targets=None) -> Dict[str, float]:
        """One AE update, then one discriminator update on a
        reconstruction by the updated AE. pixels: CLIP-normalized (B, S,
        S, 3); targets: the [-1, 1] RGB the reconstruction is held to
        (pixels themselves when None, as libra_tpu's trainer does)."""
        pixels = torch.as_tensor(pixels, device=self.device)
        targets = pixels if targets is None else torch.as_tensor(targets, device=self.device)
        with torch.no_grad():
            # the frozen encoder's features serve both updates
            feat = clip_model.forward_features(self.params["clip"], self.cfg.clip, pixels,
                                               select_layer=self.cfg.select_layer)
        ae_loss, ae_logs = self._ae_step(feat, targets)
        d_loss, d_logs = self._disc_step(feat, targets)
        self.step += 1
        logs = {"aeloss": ae_loss, "discloss": d_loss, **ae_logs, **d_logs}
        values = torch.stack([v.float() for v in logs.values()]).tolist()   # one readback
        return dict(zip(logs, values))
