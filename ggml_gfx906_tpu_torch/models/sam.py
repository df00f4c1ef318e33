"""Segment Anything (SAM, ViT-B) — encoder, prompt encoder and mask decoder;
the port of ggml_gfx906_tpu/models/sam.py.

ref: examples/sam/sam.cpp — ViT-B image encoder with windowed attention
and decomposed relative positions (the WIN_PART/WIN_UNPART/GET_REL_POS/
ADD_REL_POS ops), conv neck, fourier-feature prompt encoder, two-way
transformer mask decoder with IoU prediction.

Attention is f32 throughout and formulated as the reference's: the scores
are materialised, the decomposed relative positions added, softmax, the
product. At grid 64 the windows pad 64 to 70 with zeros after the
layernorm and attend to the padding unmasked, as the reference does.

Weights come from an HF SamModel state dict (`from_hf`, torch tensors) or
a GGUF written by `save_gguf` (gguf/pytree.py). `from_hf`, `load_gguf` and
`params_from_numpy` put the params on the card unless device="cpu" is
passed; the forward functions run where the params are.
Array layout: images (B, C, H, W); encoder tokens (B, H, W, C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import ops
from ..utils.device import resolve, to_device
from . import llama as _llama

WINDOW = 14
GLOBAL_ATTN = (2, 5, 8, 11)


@dataclass(frozen=True)
class SamConfig:
    n_enc_state: int = 768
    n_enc_layer: int = 12
    n_enc_head: int = 12
    n_img_size: int = 1024
    n_patch: int = 16
    n_embed: int = 256  # prompt/mask embedding dim
    ln_eps: float = 1e-6

    @property
    def n_grid(self) -> int:
        return self.n_img_size // self.n_patch  # 64

    @property
    def head_dim(self) -> int:
        return self.n_enc_state // self.n_enc_head


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's SAM params (numpy leaves) → the port's."""
    return _llama.params_from_numpy(tree, device)


# ---------------------------------------------------------------- encoder

def _ln(x, g, b, eps):
    return ops.norm(x, eps) * g + b


def _attn_rel_pos(x, blk, n_head, rel_h_table, rel_w_table):
    """Windowed/global attention with decomposed relative positions
    (ref sam.cpp encoder attention; HF SamVisionAttention)."""
    B, H, W, C = x.shape
    hd = C // n_head
    qkv = (x @ blk["qkv_w"].T + blk["qkv_b"]).reshape(B, H * W, 3, n_head, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(B * n_head, H * W, hd) for i in range(3))

    scale = 1.0 / np.sqrt(hd)
    att = (q * scale) @ k.transpose(1, 2)
    # decomposed rel pos: att += q·Rh + q·Rw (ref ggml_add_rel_pos)
    rh = ops.get_rel_pos(rel_h_table, H, H)  # (H, H, hd)
    rw = ops.get_rel_pos(rel_w_table, W, W)
    qg = q.reshape(B * n_head, H, W, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", qg, rh)  # (B*nh, H, W, H)
    rel_w = torch.einsum("bhwc,wkc->bhwk", qg, rw)  # (B*nh, H, W, W)
    att = att.reshape(B * n_head, H, W, H, W)
    att = att + rel_h[..., :, None] + rel_w[..., None, :]
    att = torch.softmax(att.reshape(B * n_head, H * W, H * W), dim=-1)
    out = (att @ v).reshape(B, n_head, H * W, hd)
    out = out.transpose(1, 2).reshape(B, H, W, C)
    return out @ blk["proj_w"].T + blk["proj_b"]


def encode_image(cfg: SamConfig, enc: dict, img: torch.Tensor) -> torch.Tensor:
    """img (B, 3, 1024, 1024) normalized → image embeddings (B, 256, 64, 64).
    ref: sam_encode_image (sam.cpp). Reads GLOBAL_ATTN and WINDOW at call
    time."""
    x = ops.conv_2d(img, enc["patch_w"], stride=(cfg.n_patch, cfg.n_patch))
    x = x.permute(0, 2, 3, 1) + enc["patch_b"]  # (B, 64, 64, C)
    x = x + enc["pos_embed"]

    for li, blk in enumerate(enc["blocks"]):
        shortcut = x
        h = _ln(x, blk["ln1_g"], blk["ln1_b"], cfg.ln_eps)
        B, H, W, C = h.shape
        if li not in GLOBAL_ATTN:
            h = ops.win_part(h, WINDOW)  # (B*nw, 14, 14, C)
            h = _attn_rel_pos(h, blk, cfg.n_enc_head, blk["rel_h"], blk["rel_w"])
            h = ops.win_unpart(h, H, W, WINDOW)
        else:
            h = _attn_rel_pos(h, blk, cfg.n_enc_head, blk["rel_h"], blk["rel_w"])
        x = shortcut + h
        h2 = _ln(x, blk["ln2_g"], blk["ln2_b"], cfg.ln_eps)
        h2 = ops.gelu(h2 @ blk["mlp1_w"].T + blk["mlp1_b"])
        x = x + (h2 @ blk["mlp2_w"].T + blk["mlp2_b"])

    # neck: conv1x1 → LN2d → conv3x3(p1) → LN2d (channels-last LN over C)
    y = x.permute(0, 3, 1, 2)
    y = ops.conv_2d(y, enc["neck0_w"])
    y = _ln2d(y, enc["neck1_g"], enc["neck1_b"], cfg.ln_eps)
    y = ops.conv_2d(y, enc["neck2_w"], padding=(1, 1))
    return _ln2d(y, enc["neck3_g"], enc["neck3_b"], cfg.ln_eps)  # (B, 256, 64, 64)


def _ln2d(x, g, b, eps):
    """LayerNorm over the channel axis of (B, C, H, W) (SAM's LayerNorm2d)."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return xn * g[None, :, None, None] + b[None, :, None, None]


# ---------------------------------------------------------------- prompt encoder

def encode_points(cfg: SamConfig, pe: dict, points: np.ndarray,
                  labels: np.ndarray) -> torch.Tensor:
    """points (B, N, 2) in pixel coords of the 1024-padded image, labels
    (B, N) (1 fg, 0 bg, -1 pad) → sparse embeddings (B, N+1, 256) on the
    params' device. A pad point is appended (ref prompt encoder semantics).
    The points go to the card by a pinned copy that does not wait on it."""
    dev = pe["pe_matrix"].device
    B, N, _ = points.shape
    pts = np.concatenate([points, np.zeros((B, 1, 2), points.dtype)], axis=1)
    lbl = np.concatenate([labels, -np.ones((B, 1), labels.dtype)], axis=1)
    pts = (pts + 0.5) / cfg.n_img_size
    coords = to_device(np.ascontiguousarray(pts, np.float32), dev)
    emb = _pe_encode(pe["pe_matrix"], coords)  # (B, N+1, 256)
    lbl = to_device(lbl, dev)[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(lbl == -1, pe["not_a_point"][None, None], emb + torch.where(
        lbl == 1, pe["point_pos"][None, None],
        torch.where(lbl == 0, pe["point_neg"][None, None], zero)))


def _pe_encode(pe_matrix, coords01):
    """Random fourier positional encoding (ref sam.cpp prompt encoder;
    HF SamPositionalEmbedding): coords in [0,1] → 2*pi*(2c-1)@G → [sin, cos]."""
    proj = 2.0 * np.pi * ((2.0 * coords01 - 1.0) @ pe_matrix)  # (..., 128)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def dense_pe(cfg: SamConfig, pe: dict) -> torch.Tensor:
    """Positional encoding of the 64x64 grid → (1, 256, 64, 64) (HF uses a
    separate shared_image_embedding matrix for this)."""
    g = cfg.n_grid
    dev = pe["pe_img_matrix"].device
    ys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    xs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (g, g, 2)
    enc = _pe_encode(pe["pe_img_matrix"], grid.reshape(-1, 2)).reshape(g, g, -1)
    return enc.permute(2, 0, 1)[None]


# ---------------------------------------------------------------- mask decoder

def _mlp(x, layers, act=torch.relu):
    for i, (w, b) in enumerate(layers):
        x = x @ w.T + b
        if i < len(layers) - 1:
            x = act(x)
    return x


def _decoder_attn(q, k, v, blk, prefix, n_head):
    """Downsampled multihead attention of the two-way transformer."""
    B = q.shape[0]
    qh = q @ blk[f"{prefix}_q_w"].T + blk[f"{prefix}_q_b"]
    kh = k @ blk[f"{prefix}_k_w"].T + blk[f"{prefix}_k_b"]
    vh = v @ blk[f"{prefix}_v_w"].T + blk[f"{prefix}_v_b"]
    d = qh.shape[-1] // n_head

    def split(t):
        return t.reshape(B, -1, n_head, d).transpose(1, 2)

    qh, kh, vh = split(qh), split(kh), split(vh)
    att = torch.softmax((qh @ kh.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    out = (att @ vh).transpose(1, 2).reshape(B, -1, n_head * d)
    return out @ blk[f"{prefix}_out_w"].T + blk[f"{prefix}_out_b"]


def decode_masks(cfg: SamConfig, dec: dict, pe: dict, image_emb: torch.Tensor,
                 sparse_emb: torch.Tensor, n_head: int = 8):
    """Two-way transformer mask decoder (ref sam.cpp mask decoder; HF
    SamMaskDecoder). Returns (masks (B, 4, 256, 256), iou (B, 4))."""
    B = sparse_emb.shape[0]
    out_tokens = torch.cat([dec["iou_token"], dec["mask_tokens"]], dim=0)
    tokens = torch.cat([out_tokens[None].expand(B, *out_tokens.shape), sparse_emb],
                       dim=1)  # (B, 5+N, 256)

    src = image_emb + dec["no_mask_embed"][None, :, None, None]
    pos_src = dense_pe(cfg, pe)
    src = src.reshape(B, cfg.n_embed, -1).transpose(1, 2)      # (B, 4096, 256)
    pos = pos_src.reshape(1, cfg.n_embed, -1).transpose(1, 2)

    q = tokens
    k = src
    for i, blk in enumerate(dec["layers"]):
        # self attention on tokens; the first layer REPLACES the queries with
        # the attention output (skip_first_layer_pe, no residual — HF
        # SamTwoWayAttentionBlock)
        if i == 0:
            q = _decoder_attn(q, q, q, blk, "self", n_head)
        else:
            q0 = q + tokens
            q = q + _decoder_attn(q0, q0, q, blk, "self", n_head)
        q = _ln_last(q, blk["ln1_g"], blk["ln1_b"])
        # cross attention tokens -> image
        attn = _decoder_attn(q + tokens, k + pos, k, blk, "t2i", n_head)
        q = _ln_last(q + attn, blk["ln2_g"], blk["ln2_b"])
        # mlp
        h = ops.relu(q @ blk["mlp1_w"].T + blk["mlp1_b"])
        q = _ln_last(q + (h @ blk["mlp2_w"].T + blk["mlp2_b"]), blk["ln3_g"], blk["ln3_b"])
        # cross attention image -> tokens
        attn = _decoder_attn(k + pos, q + tokens, q, blk, "i2t", n_head)
        k = _ln_last(k + attn, blk["ln4_g"], blk["ln4_b"])

    # final token->image attention
    attn = _decoder_attn(q + tokens, k + pos, k, dec["final"], "t2i", n_head)
    q = _ln_last(q + attn, dec["final"]["ln_g"], dec["final"]["ln_b"])

    iou_token_out = q[:, 0]
    mask_tokens_out = q[:, 1:5]

    # upscale image features: 4096x256 → (B, 256, 64, 64) → convT x2 → (B, 32, 256, 256)
    srcT = k.transpose(1, 2).reshape(B, cfg.n_embed, cfg.n_grid, cfg.n_grid)
    up = ops.conv_transpose_2d(srcT, dec["up1_w"], stride=2) + dec["up1_b"][None, :, None, None]
    up = ops.gelu(_ln2d(up, dec["up_ln_g"], dec["up_ln_b"], cfg.ln_eps))
    up = ops.conv_transpose_2d(up, dec["up2_w"], stride=2) + dec["up2_b"][None, :, None, None]
    up = ops.gelu(up)  # (B, 32, 256, 256)

    hyper = torch.stack([_mlp(mask_tokens_out[:, i], dec["hyper"][i]) for i in range(4)],
                        dim=1)  # (B, 4, 32)
    masks = hyper @ up.reshape(B, up.shape[1], -1)
    masks = masks.reshape(B, 4, up.shape[2], up.shape[3])
    iou = _mlp(iou_token_out, dec["iou_head"])
    return masks, iou


def _ln_last(x, g, b, eps: float = 1e-5):
    return ops.norm(x, eps) * g + b


# ---------------------------------------------------------------- converter

def from_hf(state_dict, n_layer: int = 12, device=None) -> tuple[SamConfig, dict]:
    """HF SamModel state dict (torch tensors) → (config, params) on
    `device`. Linear weights stay (out, in) and are applied as x @ W.T."""
    device = resolve(device)

    def t(n):
        return state_dict[n].detach().to(device=device, dtype=torch.float32)

    cfg = SamConfig(n_enc_layer=n_layer)
    enc = {
        "patch_w": t("vision_encoder.patch_embed.projection.weight"),
        "patch_b": t("vision_encoder.patch_embed.projection.bias"),
        "pos_embed": t("vision_encoder.pos_embed"),
        "neck0_w": t("vision_encoder.neck.conv1.weight"),
        "neck1_g": t("vision_encoder.neck.layer_norm1.weight"),
        "neck1_b": t("vision_encoder.neck.layer_norm1.bias"),
        "neck2_w": t("vision_encoder.neck.conv2.weight"),
        "neck3_g": t("vision_encoder.neck.layer_norm2.weight"),
        "neck3_b": t("vision_encoder.neck.layer_norm2.bias"),
        "blocks": [],
    }
    for i in range(n_layer):
        b = f"vision_encoder.layers.{i}."
        enc["blocks"].append({
            "ln1_g": t(b + "layer_norm1.weight"), "ln1_b": t(b + "layer_norm1.bias"),
            "qkv_w": t(b + "attn.qkv.weight"), "qkv_b": t(b + "attn.qkv.bias"),
            "proj_w": t(b + "attn.proj.weight"), "proj_b": t(b + "attn.proj.bias"),
            "rel_h": t(b + "attn.rel_pos_h"), "rel_w": t(b + "attn.rel_pos_w"),
            "ln2_g": t(b + "layer_norm2.weight"), "ln2_b": t(b + "layer_norm2.bias"),
            "mlp1_w": t(b + "mlp.lin1.weight"), "mlp1_b": t(b + "mlp.lin1.bias"),
            "mlp2_w": t(b + "mlp.lin2.weight"), "mlp2_b": t(b + "mlp.lin2.bias"),
        })
    pe = {
        "pe_matrix": t("prompt_encoder.shared_embedding.positional_embedding"),
        "pe_img_matrix": t("shared_image_embedding.positional_embedding"),
        "point_neg": t("prompt_encoder.point_embed.0.weight")[0],
        "point_pos": t("prompt_encoder.point_embed.1.weight")[0],
        "not_a_point": t("prompt_encoder.not_a_point_embed.weight")[0],
    }

    def attn(prefix_hf, prefix_my):
        return {f"{prefix_my}_{mine}_{kind}": t(f"{prefix_hf}{hf}_proj.{full}")
                for mine, hf in (("q", "q"), ("k", "k"), ("v", "v"), ("out", "out"))
                for kind, full in (("w", "weight"), ("b", "bias"))}

    def ff(prefix_hf, n_hidden_layers=1):
        layers = [(t(prefix_hf + "proj_in.weight"), t(prefix_hf + "proj_in.bias"))]
        for i in range(n_hidden_layers):
            layers.append((t(prefix_hf + f"layers.{i}.weight"),
                           t(prefix_hf + f"layers.{i}.bias")))
        layers.append((t(prefix_hf + "proj_out.weight"), t(prefix_hf + "proj_out.bias")))
        return layers

    dec = {
        "iou_token": t("mask_decoder.iou_token.weight"),
        "mask_tokens": t("mask_decoder.mask_tokens.weight"),
        "no_mask_embed": t("prompt_encoder.no_mask_embed.weight")[0],
        "up1_w": t("mask_decoder.upscale_conv1.weight"),
        "up1_b": t("mask_decoder.upscale_conv1.bias"),
        "up_ln_g": t("mask_decoder.upscale_layer_norm.weight"),
        "up_ln_b": t("mask_decoder.upscale_layer_norm.bias"),
        "up2_w": t("mask_decoder.upscale_conv2.weight"),
        "up2_b": t("mask_decoder.upscale_conv2.bias"),
        "hyper": [ff(f"mask_decoder.output_hypernetworks_mlps.{i}.") for i in range(4)],
        "iou_head": ff("mask_decoder.iou_prediction_head."),
        "layers": [],
    }
    for i in range(2):
        b = f"mask_decoder.transformer.layers.{i}."
        lyr = {}
        lyr.update(attn(b + "self_attn.", "self"))
        lyr.update(attn(b + "cross_attn_token_to_image.", "t2i"))
        lyr.update(attn(b + "cross_attn_image_to_token.", "i2t"))
        for j in range(1, 5):
            lyr[f"ln{j}_g"] = t(b + f"layer_norm{j}.weight")
            lyr[f"ln{j}_b"] = t(b + f"layer_norm{j}.bias")
        lyr["mlp1_w"] = t(b + "mlp.lin1.weight")
        lyr["mlp1_b"] = t(b + "mlp.lin1.bias")
        lyr["mlp2_w"] = t(b + "mlp.lin2.weight")
        lyr["mlp2_b"] = t(b + "mlp.lin2.bias")
        dec["layers"].append(lyr)
    fin = attn("mask_decoder.transformer.final_attn_token_to_image.", "t2i")
    fin["ln_g"] = t("mask_decoder.transformer.layer_norm_final_attn.weight")
    fin["ln_b"] = t("mask_decoder.transformer.layer_norm_final_attn.bias")
    dec["final"] = fin
    return cfg, {"enc": enc, "pe": pe, "dec": dec}


# ------------------------------------------------------------ GGUF round-trip

def save_gguf(path, cfg: SamConfig, params: dict):
    """Serialize SAM to GGUF (generic dotted-path tensor naming,
    gguf/pytree.py — the counterpart of the reference's
    examples/sam/convert-pth-to-ggml.py conversion output)."""
    from ..gguf.format import GGUFValueType
    from ..gguf.pytree import save_pytree

    kv = {
        "general.architecture": "sam",
        "sam.n_enc_state": cfg.n_enc_state,
        "sam.n_enc_layer": cfg.n_enc_layer,
        "sam.n_enc_head": cfg.n_enc_head,
        "sam.n_img_size": cfg.n_img_size,
        "sam.n_patch": cfg.n_patch,
        "sam.n_embed": cfg.n_embed,
        # FLOAT64: a FLOAT32 kv would not round-trip the Python float
        "sam.ln_eps": cfg.ln_eps,
    }
    save_pytree(path, params, kv, vtypes={"sam.ln_eps": GGUFValueType.FLOAT64})


def load_gguf(path, device=None) -> tuple[SamConfig, dict]:
    """A file of save_gguf → (config, params) on `device`."""
    from ..gguf.pytree import load_pytree

    params, kv = load_pytree(path, device)
    cfg = SamConfig(
        n_enc_state=int(kv["sam.n_enc_state"]),
        n_enc_layer=int(kv["sam.n_enc_layer"]),
        n_enc_head=int(kv["sam.n_enc_head"]),
        n_img_size=int(kv["sam.n_img_size"]),
        n_patch=int(kv["sam.n_patch"]),
        n_embed=int(kv["sam.n_embed"]),
        ln_eps=float(kv["sam.ln_eps"]),
    )
    return cfg, params
