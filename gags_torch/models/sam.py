"""Segment-Anything (SAM): image encoder, prompt encoder, mask decoder
(port of gags_tpu.models.sam).

Submodules and parameters carry the names of the segment-anything
checkpoint (`image_encoder.blocks.{i}.attn.qkv.weight`,
`prompt_encoder.pe_layer.positional_encoding_gaussian_matrix`,
`mask_decoder.transformer.layers.{i}...`), which is why they look as they
do: a real `sam_vit_*.pth` then loads with `load_state_dict(strict=True)`,
`ckpt_inventory.sam_inventory` is a check of `state_dict()` shapes, and
`weights.sam_state_from_flax` inverts the JAX package's converter. The
parts of the checkpoint that point prompts never read (the mask-prompt
downscaler, the two box-corner embeddings) are modules here all the same,
so the file loads strictly.

The arithmetic is JAX's, which differs from segment-anything's in two
places: point coordinates are not shifted by half a pixel, and the image
is resized with PIL's bilinear filter (done here without PIL, in integer
arithmetic on the device). Layouts are
PyTorch's: images and image embeddings are NCHW, the ViT blocks work
channel-last as upstream's do.

Global attention over grids of at least 2048 tokens (the 64x64 grid of
ViT-H's four global blocks) goes one band of 8 grid rows of queries at a
time through F.scaled_dot_product_attention, with the decomposed rel-pos
bias of that band as its float mask: a (B, heads, 8 w, h w) mask in place
of the (B, heads, h w, h w) scores, 128 MiB instead of 1 GiB per image at
ViT-H. As in JAX the scale is folded into K, so the bias sees unscaled q.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gags_torch import resolve_device
from gags_torch.utils.image import resize_uint8_bilinear


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    image_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280          # ViT-H
    encoder_depth: int = 32
    encoder_heads: int = 16
    window_size: int = 14
    global_attn_idx: Tuple[int, ...] = (7, 15, 23, 31)
    prompt_dim: int = 256
    decoder_heads: int = 8
    decoder_depth: int = 2
    mask_tokens: int = 4             # 1 "whole" + 3 multimask outputs

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def vit_h() -> "SAMConfig":
        return SAMConfig()

    @staticmethod
    def vit_l() -> "SAMConfig":
        return SAMConfig(encoder_dim=1024, encoder_depth=24, encoder_heads=16,
                         global_attn_idx=(5, 11, 17, 23))

    @staticmethod
    def vit_b() -> "SAMConfig":
        return SAMConfig(encoder_dim=768, encoder_depth=12, encoder_heads=12,
                         global_attn_idx=(2, 5, 8, 11))

    @staticmethod
    def tiny() -> "SAMConfig":
        return SAMConfig(image_size=64, patch_size=8, encoder_dim=32, encoder_depth=2,
                         encoder_heads=2, window_size=4, global_attn_idx=(1,),
                         prompt_dim=16, decoder_heads=2, decoder_depth=2)


BLOCKED_MIN_TOKENS = 2048  # global blocks at ViT scale (64 x 64 = 4096 tokens)
ROW_BLOCK = 8              # grid rows of queries per band of the blocked path


def rel_pos_table(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q, k, head_dim) decomposed relative-position lookup; the float
    index is truncated to an integer as JAX's astype(int32) does."""
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int32).long()]


def blocked_rel_attention(q, k_scaled, v, rh, rw, h: int, w: int, row_block: int = ROW_BLOCK):
    """Attention with SAM's decomposed rel-pos bias, one band of `row_block`
    grid rows of queries at a time; q (B, n, h w, hd) unscaled, k already
    scaled. Returns (B, n, h w, hd)."""
    b, n, _, hd = q.shape
    qb = row_block * w
    out = []
    for r0 in range(0, h, row_block):
        q_blk = q[:, :, r0 * w:r0 * w + qb]
        q5 = q_blk.reshape(b, n, row_block, w, hd)
        bias_h = torch.einsum("bnqwc,qkc->bnqwk", q5, rh[r0:r0 + row_block])  # (b,n,rb,w,h)
        bias_w = torch.einsum("bnqwc,wkc->bnqwk", q5, rw)                     # (b,n,rb,w,w)
        mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, n, qb, h * w)
        out.append(F.scaled_dot_product_attention(q_blk, k_scaled, v, attn_mask=mask, scale=1.0))
    return torch.cat(out, dim=2)


class Attention(nn.Module):
    """Multi-head attention over a (B, H, W, C) grid with decomposed
    relative positions (segment-anything's image_encoder Attention)."""

    def __init__(self, dim: int, heads: int, input_size: Tuple[int, int], device=None):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd, device=device))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        n = self.heads
        hd = c // n
        qkv = self.qkv(x).reshape(b, h * w, 3, n, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, HW, hd)
        scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=x.dtype, device=x.device))
        rh = rel_pos_table(h, h, self.rel_pos_h)
        rw = rel_pos_table(w, w, self.rel_pos_w)
        if h * w >= BLOCKED_MIN_TOKENS and h % ROW_BLOCK == 0:
            out = blocked_rel_attention(q, k * scale, v, rh, rw, h, w)
        else:
            att = (q @ k.transpose(-2, -1)) * scale
            qr = q.reshape(b, n, h, w, hd)
            bias_h = torch.einsum("bnhwc,hkc->bnhwk", qr, rh)
            bias_w = torch.einsum("bnhwc,wkc->bnhwk", qr, rw)
            att = att.reshape(b, n, h, w, h, w) + bias_h[..., :, None] + bias_w[..., None, :]
            att = torch.softmax(att.reshape(b, n, h * w, h * w), dim=-1)
            out = att @ v
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act, device=None):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden, device=device)
        self.lin2 = nn.Linear(hidden, dim, device=device)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def _window_partition(x: torch.Tensor, win: int):
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def _window_unpartition(x: torch.Tensor, win: int, padded_hw, hw):
    hp, wp = padded_hw
    h, w = hw
    b = x.shape[0] // (hp // win * wp // win)
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class Block(nn.Module):
    def __init__(self, cfg: SAMConfig, window: int, device=None):
        super().__init__()
        e = cfg.encoder_dim
        self.window = window
        span = window if window > 0 else cfg.grid
        self.norm1 = nn.LayerNorm(e, eps=1e-6, device=device)
        self.attn = Attention(e, cfg.encoder_heads, (span, span), device=device)
        self.norm2 = nn.LayerNorm(e, eps=1e-6, device=device)
        self.mlp = MLPBlock(e, 4 * e, nn.GELU(), device=device)

    def forward(self, x):
        h = self.norm1(x)
        if self.window > 0:
            hw = (h.shape[1], h.shape[2])
            h, padded = _window_partition(h, self.window)
            h = _window_unpartition(self.attn(h), self.window, padded, hw)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.encoder_dim, p, stride=p, device=device)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoder(nn.Module):
    """(B, 3, S, S) SAM-normalised images → (B, prompt_dim, grid, grid)."""

    def __init__(self, cfg: SAMConfig, device=None):
        super().__init__()
        e, g, pd = cfg.encoder_dim, cfg.grid, cfg.prompt_dim
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, e, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_idx else cfg.window_size, device=device)
            for i in range(cfg.encoder_depth))
        self.neck = nn.Sequential(
            nn.Conv2d(e, pd, 1, bias=False, device=device), LayerNorm2d(pd, device=device),
            nn.Conv2d(pd, pd, 3, padding=1, bias=False, device=device),
            LayerNorm2d(pd, device=device))

    def forward(self, images):
        x = self.patch_embed(images) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int, device=None):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats, device=device))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]^2, (..., 2) → (..., 2 num_pos_feats). The K = 2
        product is written out, so it is true float32 on any device."""
        x = 2.0 * coords - 1.0
        g = self.positional_encoding_gaussian_matrix
        x = x[..., 0:1] * g[0] + x[..., 1:2] * g[1]
        x = x * (2.0 * np.pi)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)

    def dense(self, grid: int) -> torch.Tensor:
        """(grid, grid, d) encoding of the cell centres, [..., 0] = x."""
        dev = self.positional_encoding_gaussian_matrix.device
        c = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) / grid
        ys, xs = torch.meshgrid(c, c, indexing="ij")
        return self.encode(torch.stack([xs, ys], -1))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None):
        super().__init__()
        d = cfg.prompt_dim
        mc = 16  # mask_in_chans of the mask-prompt downscaler (unused by points)
        self.pe_layer = PositionEmbeddingRandom(d // 2, device=device)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d, device=device) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d, device=device)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, stride=2, device=device), LayerNorm2d(mc // 4, device=device),
            nn.GELU(), nn.Conv2d(mc // 4, mc, 2, stride=2, device=device),
            LayerNorm2d(mc, device=device), nn.GELU(), nn.Conv2d(mc, d, 1, device=device))
        self.no_mask_embed = nn.Embedding(1, d, device=device)

    def forward(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points (B, P, 2) in [0, 1]; labels (B, P) in {-1 pad, 0 neg, 1
        pos} → sparse embeddings (B, P + 1, d), with the padding point SAM
        appends when no box is given."""
        b = points.shape[0]
        pts = torch.cat([points, torch.zeros((b, 1, 2), dtype=points.dtype, device=points.device)], 1)
        lbl = torch.cat([labels, -torch.ones((b, 1), dtype=labels.dtype, device=labels.device)], 1)
        emb = self.pe_layer.encode(pts)
        lbl = lbl[..., None]
        emb = torch.where(lbl == -1, self.not_a_point_embed.weight[0], emb)
        emb = torch.where(lbl == 0, emb + self.point_embeddings[0].weight[0], emb)
        return torch.where(lbl == 1, emb + self.point_embeddings[1].weight[0], emb)


class TwoWayAttention(nn.Module):
    """segment-anything's decoder Attention (q/k/v/out projections with an
    optional downsampled inner width)."""

    def __init__(self, dim: int, heads: int, downsample: int = 1, device=None):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner, device=device)
        self.k_proj = nn.Linear(dim, inner, device=device)
        self.v_proj = nn.Linear(dim, inner, device=device)
        self.out_proj = nn.Linear(inner, dim, device=device)

    def forward(self, q, k, v):
        def split(t):
            b, n, c = t.shape
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        q, k, v = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        hd = q.shape[-1]
        att = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(hd), dim=-1)
        out = (att @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, skip_first_layer_pe: bool, device=None):
        super().__init__()
        d, nh = cfg.prompt_dim, cfg.decoder_heads
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = TwoWayAttention(d, nh, device=device)
        self.norm1 = nn.LayerNorm(d, device=device)
        self.cross_attn_token_to_image = TwoWayAttention(d, nh, 2, device=device)
        self.norm2 = nn.LayerNorm(d, device=device)
        self.mlp = MLPBlock(d, 8 * d, nn.ReLU(), device=device)
        self.norm3 = nn.LayerNorm(d, device=device)
        self.norm4 = nn.LayerNorm(d, device=device)
        self.cross_attn_image_to_token = TwoWayAttention(d, nh, 2, device=device)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None):
        super().__init__()
        d = cfg.prompt_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, i == 0, device=device) for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = TwoWayAttention(d, cfg.decoder_heads, 2, device=device)
        self.norm_final_attn = nn.LayerNorm(d, device=device)

    def forward(self, src, pe, tokens):
        q, k = tokens, src
        for layer in self.layers:
            q, k = layer(q, k, tokens, pe)
        q = self.norm_final_attn(q + self.final_attn_token_to_image(q + tokens, k + pe, k))
        return q, k


class MLP(nn.Module):
    def __init__(self, dim_in: int, hidden: int, dim_out: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(dim_in, hidden, device=device),
                                     nn.Linear(hidden, hidden, device=device),
                                     nn.Linear(hidden, dim_out, device=device)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None):
        super().__init__()
        d, nt = cfg.prompt_dim, cfg.mask_tokens
        self.transformer = TwoWayTransformer(cfg, device=device)
        self.iou_token = nn.Embedding(1, d, device=device)
        self.mask_tokens = nn.Embedding(nt, d, device=device)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2, device=device),
            LayerNorm2d(d // 4, device=device), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2, device=device), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, device=device) for _ in range(nt))
        self.iou_prediction_head = MLP(d, d, nt, device=device)

    def forward(self, image_embed, image_pe, sparse):
        """image_embed (B, d, g, g); image_pe (d, g, g); sparse (B, P, d).

        Returns (masks (B, 4, 4g, 4g) low-res logits, iou_pred (B, 4));
        mask channel 0 is the single-mask output, 1..3 subpart / part /
        whole."""
        b, d, g, _ = image_embed.shape
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([tokens.expand(b, -1, -1), sparse], 1)
        src = image_embed.flatten(2).transpose(1, 2)
        pe = image_pe.flatten(1).transpose(0, 1).expand(b, -1, -1)
        q, k = self.transformer(src, pe, tokens)
        up = self.output_upscaling(k.transpose(1, 2).reshape(b, d, g, g))
        hyper = torch.stack([mlp(q[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("bkc,bchw->bkhw", hyper, up)
        return masks, self.iou_prediction_head(q[:, 0])


class SAM(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg, device=device)
        self.prompt_encoder = PromptEncoder(cfg, device=device)
        self.mask_decoder = MaskDecoder(cfg, device=device)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(images)

    def decode(self, image_embed: torch.Tensor, points: torch.Tensor, labels: torch.Tensor):
        """image_embed (1, d, g, g) of one image; points (B, P, 2) in [0, 1]
        of the padded frame; labels (B, P). Returns (masks (B, 4, 4g, 4g),
        iou_pred (B, 4))."""
        sparse = self.prompt_encoder(points, labels)
        pe = self.prompt_encoder.pe_layer.dense(image_embed.shape[-1]).permute(2, 0, 1)
        # the no-mask dense embedding is added when no mask prompt is given
        embed = image_embed + self.prompt_encoder.no_mask_embed.weight[0][:, None, None]
        embed = embed.expand(points.shape[0], -1, -1, -1)
        return self.mask_decoder(embed, pe, sparse)

    def forward(self, images, points, labels):
        return self.decode(self.encode_image(images)[:1], points, labels)


SAM_IMAGE_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_IMAGE_STD = np.array([58.395, 57.12, 57.375], np.float32)


def resize_geometry(h: int, w: int, size: int = 1024) -> Tuple[int, int]:
    """(nh, nw) of ResizeLongestSide, the geometry of preprocess_sam_image."""
    scale = size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def preprocess_sam_image(img: np.ndarray, size: int = 1024, device="cuda"
                         ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """uint8 (H, W, 3) → (1, 3, size, size) float32 on `device`, normalised,
    the long side resized to `size` with PIL's bilinear filter computed on
    the device (utils.image.resize_uint8_bilinear, no PIL needed),
    zero-padded bottom and right."""
    device = resolve_device(device)
    h, w = img.shape[:2]
    nh, nw = resize_geometry(h, w, size)
    x = resize_uint8_bilinear(torch.as_tensor(img, device=device), (nh, nw)).to(torch.float32)
    x = (x - torch.as_tensor(SAM_IMAGE_MEAN, device=device)) / torch.as_tensor(SAM_IMAGE_STD,
                                                                                device=device)
    out = torch.zeros((1, 3, size, size), dtype=torch.float32, device=device)
    out[0, :, :nh, :nw] = x.permute(2, 0, 1)
    return out, (nh, nw)
