"""Captioner (LLaVA) training, on one card or over a mesh (counterpart of
supir_tpu/captioner/train.py; reference llava/train/train.py and
llava_trainer.py): causal-LM cross entropy on conversation data with the
image's patch embeddings spliced in, in three modes:

  full       the projector and the whole Llama (train.py's default)
  projector  the mm projector alone (--tune_mm_mlp_adapter, train.py:133-142)
  lora       the projector and low-rank adapters on every target projection
             of the Llama (train.py:100-104, find_all_linear_names:163)

The CLIP vision tower is always frozen; `train_step_tokens` runs it under
`torch.no_grad()`, so it keeps no activations. Batches come from
`captioner/data.py:rank_batches` and `preprocess.collate`.

LoRA. `init_lora` gives each nn.Linear of the Llama blocks named in
LORA_TARGETS an `a` [in, r] drawn N(0, 1)/r and a zero `b` [r, out], both
fp32, under the keys `model.layers.{i}.{self_attn|mlp}.{proj}.lora_a` and
`.lora_b` (JAX's layout: its kernels are [in, out]). The forward uses the
merged kernel, as JAX's `merge_lora` builds it: kernel + (alpha/r) *
(a @ b) cast to the kernel's dtype, the transpose of that in the port's
[out, in] layout. Each adapted projection runs `MergedLoRALinear`, which
merges in its forward and merges again in its backward rather than keep
the merged kernel: at 13B the 280 merged kernels would hold another 26 GB
for the backward. The merged form is kept (not x W + s (x a) b, which
rounds differently in bf16).

Kept from the JAX trainer:
- `torch.optim.AdamW` with optax's `adamw` defaults: b1 0.9, b2 0.999, eps
  1e-8 outside the square root and weight decay 1e-4 on every trainable
  leaf (optax's default mask decays all of them; torch's own default is
  0.01); fused on every device, so the CPU parity tests run the optimizer
  the card runs. A trainable leaf that gets no gradient in a
  step (the token table in the feature-level step) gets a zero gradient,
  so it decays as optax decays it.
- the trainable leaves and their AdamW moments are fp32: `init_state`
  widens any trainable parameter that is narrower. A frozen base keeps its
  dtype (bf16 at 13B) and its bits.
- the forward computes in the agent's `compute_dtype` (JAX's agent
  :63, :132, float32 by default): bf16 runs under bf16 autocast on the
  card, float32 with none (`engine/training.py:train_autocast`); the
  merged LoRA kernels are built in fp32 and cast, as JAX casts them.
- `train_step_tokens` splices with static shapes, as the JAX step does:
  each row's output holds T + P - 1 positions whether or not it holds the
  image marker.
- `shard_state` (JAX :135-147) in every mode: the model's tensors, the
  frozen base as the trainable leaves, the LoRA adapters and AdamW's
  moments held as this rank's shards over the mesh's 'model' axis by the
  FSDP rule (`parallel/sharding.py`); each rank's optimizer steps its own
  shards. As in JAX, the batch is not split: every rank computes the step
  on the whole batch, so a shard's gradient is its slice of the one-card
  gradient.
Difference: the selective saves write one `.safetensors` file (JAX writes
an orbax tree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.captioner.preprocess import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from supir_tpu_torch.captioner.vision import select_patch_features
from supir_tpu_torch.engine.training import set_adam_state, train_autocast
from supir_tpu_torch.parallel.sharding import drop_gathered, full_tensor, held_parameters, local_block, shard_module

__all__ = ["IGNORE_INDEX", "LORA_TARGETS", "MODES", "CaptionerTrainer", "MergedLoRALinear", "causal_lm_loss",
           "init_lora", "lora_sites", "merge_lora", "merged_weight", "splice_image"]

LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
MODES = ("full", "projector", "lora")
WEIGHT_DECAY = 1e-4  # optax's adamw default, on every trainable leaf
PROJECTOR = "model.mm_projector."


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy with IGNORE_INDEX masked (train.py:84-94):
    logits [B, S, V] predict labels [B, S] shifted by one; the mean over
    the unmasked targets (0 if there are none). The log-softmax is taken in
    fp32 whatever the logits' dtype."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    mask = targets != IGNORE_INDEX
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(mask, targets, 0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


# ------------------------------------------------------------------ LoRA


def lora_modules(model: nn.Module) -> Dict[str, nn.Linear]:
    """The adapted projections of a LlavaForCausalLM (or LlamaForCausalLM)
    by their prefix: every nn.Linear of the Llama blocks named in
    LORA_TARGETS (quantized and merged projections are not nn.Linear, and
    JAX's `init_lora` skips them too)."""
    return {f"model.layers.{i}.{group}.{name}": m
            for i, layer in enumerate(model.model.layers)
            for group in ("self_attn", "mlp")
            for name, m in getattr(layer, group).named_children()
            if name in LORA_TARGETS and isinstance(m, nn.Linear)}


def init_lora(model: nn.Module, rank: int = 64,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """fp32 adapters on the model's device for every target projection
    (`lora_modules`): `{prefix}.lora_a` [in, rank] drawn N(0, 1)/rank from
    `generator`, `{prefix}.lora_b` [rank, out] zero."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, m in lora_modules(model).items():
        dev = m.weight.device
        a = torch.randn(m.in_features, rank, generator=generator, device=dev, dtype=torch.float32)
        out[f"{prefix}.lora_a"] = a * (1.0 / rank)
        out[f"{prefix}.lora_b"] = torch.zeros(rank, m.out_features, device=dev, dtype=torch.float32)
    return out


def merged_weight(weight: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """weight [out, in] + scale * (a @ b)^T, JAX's merge on the transposed
    kernel: a @ b in fp32, cast to the weight's dtype, scaled and added
    there."""
    return weight + scale * (a.float() @ b.float()).t().to(weight.dtype)


def merge_lora(state_dict: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor], alpha: float = 16.0,
               rank: int = 64) -> Dict[str, torch.Tensor]:
    """A state dict with every adapted `{prefix}.weight` merged
    (`merged_weight`, scale alpha / rank); other keys as they are."""
    out = dict(state_dict)
    for key in lora:
        if key.endswith(".lora_a"):
            prefix = key[: -len(".lora_a")]
            out[f"{prefix}.weight"] = merged_weight(state_dict[f"{prefix}.weight"], lora[key],
                                                    lora[f"{prefix}.lora_b"], alpha / rank)
    return out


class MergedLoRALinear(torch.autograd.Function):
    """y = x W'^T with W' = merged_weight(W, a, b, scale), differentiated
    in a and b (and x); W is frozen. The forward saves x, W, a and b, not
    W', and the backward merges again: dx = dy W', and from
    dW' = dy^T x, d(a b) = scale * dW'^T in fp32, da = d(a b) b^T,
    db = a^T d(a b), as JAX differentiates its merged kernel. Runs in W's
    dtype outside autocast."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, a, b, scale):
        with torch.autocast(x.device.type, enabled=False):
            w = merged_weight(weight, a, b, scale)
            y = F.linear(x.to(w.dtype), w)
        ctx.save_for_backward(x, weight, a, b)
        ctx.scale = scale
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, weight, a, b = ctx.saved_tensors
        with torch.autocast(dy.device.type, enabled=False):
            w = merged_weight(weight, a, b, ctx.scale)
            dy = dy.to(w.dtype)
            dx = dy @ w if ctx.needs_input_grad[0] else None
            dw = dy.reshape(-1, dy.shape[-1]).t() @ x.to(w.dtype).reshape(-1, x.shape[-1])  # [out, in]
            dab = (dw.t() * ctx.scale).float()
            da = dab @ b.float().t()
            db = a.float().t() @ dab
        return (None if dx is None else dx.to(x.dtype)), None, da, db, None


class lora_sites:
    """While entered, each adapted projection of `model` runs
    MergedLoRALinear on its frozen weight and its adapters from `lora`
    (keys as `init_lora` gives them); the modules and their state dict are
    left as they were."""

    def __init__(self, model: nn.Module, lora: Mapping[str, torch.Tensor], scale: float):
        self.sites = [(m, lora[f"{prefix}.lora_a"], lora[f"{prefix}.lora_b"])
                      for prefix, m in lora_modules(model).items() if f"{prefix}.lora_a" in lora]
        self.scale = scale

    def __enter__(self):
        for m, a, b in self.sites:
            m.forward = (lambda x, m=m, a=a, b=b: MergedLoRALinear.apply(x, m.weight, a, b, self.scale))
        return self

    def __exit__(self, *exc):
        for m, _, _ in self.sites:
            del m.forward


# ---------------------------------------------------------------- splice


def splice_image(tok_emb: torch.Tensor, img_emb: torch.Tensor, ids: torch.Tensor,
                 labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text embeddings [B, T, D] and image embeddings [B, P, D] -> [B, T+P-1,
    D], each row spliced at its first IMAGE_TOKEN_INDEX marker, and the
    labels [B, T+P-1] with the image span IGNORE_INDEX (train.py:217-234,
    the static-shape form of llava_arch.py:95-213). A row without a marker
    keeps its text at the front; its tail repeats the last token with label
    IGNORE_INDEX."""
    b, t, d = tok_emb.shape
    p = img_emb.shape[1]
    is_marker = ids == IMAGE_TOKEN_INDEX
    has_img = is_marker.any(dim=1, keepdim=True)
    pos = is_marker.to(torch.int32).argmax(dim=1, keepdim=True)  # the first marker; 0 without one
    j = torch.arange(t + p - 1, device=ids.device)[None]
    in_img = has_img & (j >= pos) & (j < pos + p)
    text_idx = torch.where(has_img & (j >= pos + p), j - (p - 1), j)
    text_idx = torch.where(in_img, 0, text_idx).clamp(0, t - 1)
    img_idx = (j - pos).clamp(0, p - 1)
    text = tok_emb.gather(1, text_idx[..., None].expand(b, -1, d))
    image = img_emb.to(tok_emb.dtype).gather(1, img_idx[..., None].expand(b, -1, d))
    emb = torch.where(in_img[..., None], image, text)
    pad_tail = ~has_img & (j >= t)
    lab = torch.where(in_img | pad_tail, IGNORE_INDEX, labels.gather(1, text_idx))
    return emb, lab


# --------------------------------------------------------------- trainer


class _Adapters(nn.Module):
    """The LoRA adapters as parameters of one module, so that
    `shard_module` shards them as it shards the model: `p<i>` is the
    adapter of key `keys[i]`."""

    def __init__(self, lora: Mapping[str, torch.Tensor]):
        super().__init__()
        self.keys = list(lora)
        for i, k in enumerate(self.keys):
            self.register_parameter(f"p{i}", lora[k])

    def values(self) -> Dict[str, torch.Tensor]:
        """{key: the adapter as the forward reads it (gathered where sharded)}."""
        return {k: getattr(self, f"p{i}") for i, k in enumerate(self.keys)}


class CaptionerTrainer:
    """Trainer of a CaptionerAgent's unquantized LlavaForCausalLM
    (`captioner/agent.py:create_captioner`, on the card unless the caller
    names the CPU), on one card or, after `shard_state`, over `mesh`.
    mode: "full" | "projector" | "lora" (MODES).

    `train_step(batch)` is the feature-level step ({image_feats [B, P, Dv],
    pre_embeds [B, n, D], post_embeds [B, m, D], labels [B, n+P+m]});
    `train_step_tokens(batch)` the token-level one on `preprocess.collate`
    batches ({input_ids [B, T], labels [B, T], images [B, S, S, 3]}). Each
    returns the step's loss, fp32 and detached."""

    def __init__(self, agent, mesh=None, learning_rate: float = 2e-5, mode: str = "full", lora_rank: int = 64,
                 lora_alpha: float = 16.0):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.agent = agent
        self.model = agent.model
        self.mesh = mesh
        self.mode = mode
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.learning_rate = learning_rate
        self.device = agent.model.device
        self.compute_dtype = agent.dtype
        self.lora: Dict[str, nn.Parameter] = {}
        self.adapters: Optional[_Adapters] = None  # the adapters' module once sharded
        self.sharded = False

    # ------------------------------------------------------------- state

    def trainable_of(self) -> Dict[str, torch.Tensor]:
        """The leaves that train, by name: the projector, and the LoRA
        adapters ("lora") or every Llama parameter ("full"); this rank's
        shards once sharded."""
        named = {k: p for k, (p, _) in held_parameters(self.model).items()}
        out = {k: p for k, p in named.items() if k.startswith(PROJECTOR)}
        if self.mode == "lora":
            out.update(self.lora)
        elif self.mode == "full":
            out.update({k: p for k, p in named.items()
                        if not k.startswith((PROJECTOR, "model.vision_tower."))})
        return out

    def init_state(self, lora: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0) -> Dict[str, Any]:
        """Fresh AdamW moments and step 0. In "lora" mode the adapters are
        `lora` where given (e.g. `utils/weights.py:lora_state_dict_from_jax`),
        else `init_lora` drawn from `seed` on the device. Trainable leaves
        are widened to fp32; every other parameter is frozen."""
        if self.mode == "lora":
            if lora is None:
                lora = init_lora(self.model, self.lora_rank, torch.Generator(device=self.device).manual_seed(seed))
            self.lora = {k: nn.Parameter(torch.as_tensor(v).to(self.device, torch.float32).clone())
                         for k, v in lora.items()}
        if self.sharded:
            raise RuntimeError("init_state draws whole tensors: call it before shard_state")
        self.model.requires_grad_(False)
        self.params = self.trainable_of()
        for p in self.params.values():
            if p.dtype != torch.float32:
                p.data = p.data.float()
            p.requires_grad_(True)
        self._optimizer()
        self.step = 0
        return self.state()

    def _optimizer(self) -> None:
        self.optimizer = torch.optim.AdamW(list(self.params.values()), lr=self.learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=WEIGHT_DECAY, fused=True)

    def _dims(self) -> Dict[str, Optional[int]]:
        """Every parameter's and adapter's split dim by name (None: whole)."""
        dims = {k: d for k, (_, d) in held_parameters(self.model).items()}
        if self.adapters is not None:
            held = held_parameters(self.adapters)
            dims.update({k: held[f"p{i}"][1] for i, k in enumerate(self.adapters.keys)})
        return dims

    def shard_state(self) -> "CaptionerTrainer":
        """Hold the model (the frozen base as the trainable leaves), the LoRA
        adapters and AdamW's moments as this rank's shards over the mesh's
        'model' axis (JAX :135-147), after `init_state`; a no-op without a
        mesh. Every rank calls it on the same state."""
        if self.mesh is None or self.sharded:
            return self
        state = self.state()
        shard_module(self.model, self.mesh)
        if self.lora:
            self.adapters = shard_module(_Adapters(self.lora), self.mesh)
            held = held_parameters(self.adapters)
            self.lora = {k: held[f"p{i}"][0] for i, k in enumerate(self.adapters.keys)}
        self.sharded = True
        self.params = self.trainable_of()
        self._optimizer()
        dims = self._dims()
        cut = {m: {k: local_block(v, dims[k], self.mesh) for k, v in state[m].items()}
               for m in ("exp_avg", "exp_avg_sq")}
        set_adam_state(self.optimizer, self.params, cut["exp_avg"], cut["exp_avg_sq"], self.step)
        return self

    def _full(self, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors by name (gathered over 'model' once sharded)."""
        if not self.sharded:
            return dict(tree)
        dims = self._dims()
        return {k: full_tensor(v, dims[k], self.mesh) for k, v in tree.items()}

    def state(self) -> Dict[str, Any]:
        """'params' (every parameter of the model), 'lora', 'exp_avg' and
        'exp_avg_sq' (AdamW's moments of the trainable leaves, optax's mu
        and nu; empty before the first step) and 'step'; full tensors,
        gathered once sharded."""
        opt = self.optimizer.state
        full = self._full
        return {
            "params": full({k: p for k, (p, _) in held_parameters(self.model).items()}),
            "lora": full(self.lora),
            "exp_avg": full({k: opt[p]["exp_avg"] for k, p in self.params.items() if p in opt}),
            "exp_avg_sq": full({k: opt[p]["exp_avg_sq"] for k, p in self.params.items() if p in opt}),
            "step": self.step,
        }

    # -------------------------------------------------------------- steps

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _logits(self, embeds: torch.Tensor) -> torch.Tensor:
        b, s = embeds.shape[:2]
        positions = torch.arange(s, device=self.device)[None].expand(b, -1)
        if self.mode != "lora":
            return self.model(embeds, positions)
        lora = self.adapters.values() if self.adapters is not None else self.lora
        with lora_sites(self.model, lora, self.lora_alpha / self.lora_rank):
            return self.model(embeds, positions)

    def _apply(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward, AdamW (a trainable leaf without a gradient gets a zero
        one), the step count."""
        loss.backward()
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        for module in (self.model, self.adapters):
            if module is not None:
                drop_gathered(module)
        self.step += 1
        return loss.detach()

    def _loss_features(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """The feature-level step's loss: projected image features between
        the given text embeddings."""
        with train_autocast(self.device, self.compute_dtype):
            img = self.model.model.mm_projector(self._tensor(batch["image_feats"], torch.float32))
            dt = self.model.dtype
            embeds = torch.cat([self._tensor(batch["pre_embeds"]).to(dt), img.to(dt),
                                self._tensor(batch["post_embeds"]).to(dt)], dim=1)
            logits = self._logits(embeds)
        return causal_lm_loss(logits, self._tensor(batch["labels"], torch.long))

    def _loss_tokens(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """The token-level step's loss: the frozen tower's patch features,
        projected and spliced at each row's image marker."""
        ids = self._tensor(batch["input_ids"], torch.long)
        with train_autocast(self.device, self.compute_dtype):
            with torch.no_grad():
                hidden = self.model.vision(self._tensor(batch["images"], torch.float32))
                feats = select_patch_features(hidden, self.agent.cfg.mm_hidden_layer)
            img = self.model.model.mm_projector(feats)
            tok = self.model.embed(ids.clamp_min(0))
            embeds, labels = splice_image(tok, img, ids, self._tensor(batch["labels"], torch.long))
            logits = self._logits(embeds)
        return causal_lm_loss(logits, labels)

    def train_step(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return self._apply(self._loss_features(batch))

    def train_step_tokens(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return self._apply(self._loss_tokens(batch))

    # -------------------------------------------------------------- saves

    def _projector_state(self) -> Dict[str, torch.Tensor]:
        held = {k: p for k, (p, _) in held_parameters(self.model).items() if k.startswith(PROJECTOR)}
        return {k: p.detach() for k, p in self._full(held).items()}

    def save_projector_only(self, path: str) -> None:
        """The mm projector alone as one safetensors file
        (llava_trainer.py:150-169)."""
        from supir_tpu_torch.utils.checkpoint import save_params

        save_params(path, self._projector_state())

    def save_lora_only(self, path: str) -> None:
        """The adapters and the projector as one safetensors file (the
        reference's get_peft_state_maybe_zero_3 save, train.py:109-131)."""
        from supir_tpu_torch.utils.checkpoint import save_params

        save_params(path, {**{k: p.detach() for k, p in self._full(self.lora).items()}, **self._projector_state()})
