"""Few-shot adaptive-SPADE generator (port of
fsvid2vid_tpu/models/generator.py, reference models/networks/generator.py),
NCHW inside.

Ported: the reference encoder with its K-reference attention, the weight
generation (fc stacks with the reference's flat-split order), the flow
branches, the SPADE-combine embeddings and the main branch, plus the two
serving caches (`encode_reference` for K = 1, `encode_reference_multi` for
K > 1).  At eval with K > 1 the attention runs the hand-written CUDA kernel
(ops/attention_kernel.py) on the card.

`forward` follows `module.training`.  In train mode (K = 1 only) batch norms
use batch statistics and every spectral-norm layer advances its u / v once
per call, so a module that is called twice in one forward (the shared flow
network, the up blocks that also produce the raw output) advances twice,
as in the reference.

Not ported: K > 1 in train mode (the attention kernel is forward only), the
VAE branch (use_kld), adaptive_conv, and the face-refinement forward.  They
raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.models.embedder import LabelEmbedder, channel_schedule
from fsvid2vid_tpu_torch.models.flow_generator import FlowGenerator
from fsvid2vid_tpu_torch.models.layers import (
    SNLinear, SpadeConv2d, SpadeResnetBlock)
from fsvid2vid_tpu_torch.ops.attention_kernel import flash_ref_attention
from fsvid2vid_tpu_torch.ops.image_ops import leaky_relu, upsample_nearest
from fsvid2vid_tpu_torch.ops.warp import flow_warp


def pick_ref(refs: torch.Tensor, ref_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """The most-attended reference of each sample (reference
    base_network.py:40-47).  refs: (B, K, C, H, W); ref_idx: (B,) or None
    for the first reference."""
    if ref_idx is None:
        return refs[:, 0]
    return refs[torch.arange(refs.shape[0], device=refs.device), ref_idx]


class FewShotGenerator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.use_kld:
            raise NotImplementedError("the VAE branch (use_kld) is not ported")
        if cfg.adaptive_conv:
            raise NotImplementedError("adaptive_conv is not ported")
        if cfg.use_label_ref != "mul":
            raise NotImplementedError(
                f"use_label_ref={cfg.use_label_ref!r} is not ported (every "
                "preset uses 'mul')")
        self.cfg = cfg
        # the K > 1 attention; a check may swap in flash_ref_attention_plain
        self.attention = flash_ref_attention
        nd = cfg.n_downsample_G
        self.nd = nd
        self.ch = ch = channel_schedule(cfg.ngf, nd + 1, min(1024, cfg.ngf * 2 ** nd))
        self.adap_spade = cfg.adaptive_spade
        self.adap_embed = cfg.adap_embed
        self.n_adaptive = cfg.n_adaptive
        self.warp_ref = cfg.warp_ref
        norm, norm_ref = cfg.norm_G, cfg.norm_G.replace("spade", "")
        label_nc = cfg.gen_input_nc

        # --- reference encoder; reference labels are encoded beside the
        # images and multiplied in (use_label_ref='mul') ---
        self.ref_img_first = SpadeConv2d(cfg.output_nc, cfg.ngf, norm_ref)
        self.ref_label_first = SpadeConv2d(label_nc, cfg.ngf, norm_ref)
        for i in range(nd):
            if cfg.res_for_ref:
                down = SpadeResnetBlock(ch[i], ch[i + 1], norm_ref, stride=2)
                up = SpadeResnetBlock(ch[i + 1], ch[i], norm_ref)
            else:
                down = SpadeConv2d(ch[i], ch[i + 1], norm_ref, stride=2)
                up = SpadeConv2d(ch[i + 1], ch[i], norm_ref)
            setattr(self, f"ref_img_down_{i}", down)
            setattr(self, f"ref_img_up_{i}", up)
            setattr(self, f"ref_label_down_{i}",
                    SpadeConv2d(ch[i], ch[i + 1], norm_ref, stride=2))
            setattr(self, f"ref_label_up_{i}",
                    SpadeConv2d(ch[i + 1], ch[i], norm_ref))

        # --- weight-generation fc stacks (reference generator.py:79-110) ---
        if self.adap_spade:
            sks2, eks2 = cfg.spade_ks ** 2, cfg.embed_ks ** 2
            for i in range(self.n_adaptive):
                ch_in, ch_out = ch[i], ch[i + 1]
                ch_h = self.hidden_ncs(i)[0]
                fc_in = ch[min(nd, i + 1)]
                outs = [("fc_spade_0", (ch_h * sks2 + 1) * 2),
                        ("fc_spade_1", (ch_h * sks2 + 1) * (1 if ch_in != ch_out else 2)),
                        ("fc_spade_s", (ch_h * sks2 + 1) * 2)]
                if self.adap_embed:
                    outs.append(("fc_spade_e", ch_in * eks2 + 1))
                for name, fc_out in outs:
                    layers = [SNLinear(fc_in, ch_out)]
                    for _ in range(1, cfg.n_fc_layers):
                        layers += [nn.LeakyReLU(0.2), SNLinear(ch_out, ch_out)]
                    layers += [nn.LeakyReLU(0.2), SNLinear(ch_out, fc_out)]
                    setattr(self, f"{name}_{i}", nn.Sequential(*layers))

        # --- label embedding pyramid and main branch ---
        self.label_embedding = LabelEmbedder(
            label_nc, cfg.netS, cfg.ngf, nd,
            params_free_layers=self.n_adaptive if self.adap_embed else 0)
        for i in range(nd + 1):
            setattr(self, f"up_{i}", SpadeResnetBlock(
                ch[i + 1], ch[i], norm=norm, hidden_ncs=self.hidden_ncs(i),
                conv_ks=cfg.conv_ks, spade_ks=cfg.spade_ks,
                norm_params_free=self.adap_spade and i < self.n_adaptive))
        self.conv_img = nn.Conv2d(ch[0], 3, 3, padding=1)

        # --- multi-reference attention (reference generator.py:127-134) ---
        if cfg.n_shot > 1:
            self.atn_query_first = SpadeConv2d(label_nc, cfg.ngf, norm_ref)
            self.atn_key_first = SpadeConv2d(label_nc, cfg.ngf, norm_ref)
            for i in range(cfg.n_downsample_A):
                setattr(self, f"atn_key_{i}",
                        SpadeConv2d(ch[i], ch[i + 1], norm_ref, stride=2))
                setattr(self, f"atn_query_{i}",
                        SpadeConv2d(ch[i], ch[i + 1], norm_ref, stride=2))

        # --- flow branches (reference generator.py:146-179); a shared
        # network is registered under both names, as the reference does ---
        if self.warp_ref:
            self.flow_network_ref = FlowGenerator(cfg, 2)
            if cfg.spade_combine:
                self.img_ref_embedding = LabelEmbedder(
                    cfg.output_nc + 1, cfg.sc_arch, cfg.ngf, nd)
        if cfg.n_frames_G > 1:
            self.flow_network_temp = (
                self.flow_network_ref if cfg.flow_temp_is_shared
                else FlowGenerator(cfg, cfg.n_frames_G))
            if cfg.spade_combine:
                self.img_prev_embedding = (
                    self.img_ref_embedding if cfg.prev_embedding_is_shared
                    else LabelEmbedder(cfg.output_nc + 1, cfg.sc_arch,
                                       cfg.ngf, nd))

    def hidden_ncs(self, i: int) -> List[int]:
        """SPADE modulation-map channels at layer i."""
        if self.cfg.spade_combine and i < self.cfg.n_sc_layers:
            return [self.ch[i]] * 3
        return [self.ch[i]]

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "the serving caches are built at eval; call .eval() on the "
                "generator")

    # ------------------------------------------------------------------
    # attention (reference generator.py:291-316)
    # ------------------------------------------------------------------
    def _attention_encode(self, x, kind: str):
        x = getattr(self, f"atn_{kind}_first")(x)
        for i in range(self.cfg.n_downsample_A):
            x = getattr(self, f"atn_{kind}_{i}")(x)
        return x

    def _attention_module(self, x, x_label, label, label_ref, key=None):
        """x, x_label: (B*K, c, h, w) features to combine; label: (B, Cl, H, W);
        label_ref: (B*K, Cl, H, W); key: cached key encoding or None.

        Key n of sample b is reference k = n // hw at pixel (y, x), with
        n = k*hw + y*w + x, as in the JAX package.  Returns (out_x, out_label,
        atn_sum (B, K), atn_vis (1, 1, h, w))."""
        bk, c, h, w = x.shape
        n = self.cfg.n_shot
        b = bk // n
        if key is None:
            key = self._attention_encode(label_ref, "key")
        query = self._attention_encode(label, "query")

        def tokens(t, rows):  # (rows, c, h, w) -> (b, rows // b * hw, c)
            return t.to(x.dtype).permute(0, 2, 3, 1).reshape(b, rows // b * h * w, c)

        lf = tokens(x_label, bk) if x_label is not None else None
        out_x, out_l, vis = self.attention(
            tokens(query, b), tokens(key, bk), tokens(x, bk), lf, n)
        atn_sum = vis.sum(1)
        out_x = out_x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if out_l is not None:
            out_l = out_l.reshape(b, h, w, c).permute(0, 3, 1, 2)
        atn_vis = vis.transpose(1, 2).reshape(b, n, h, w)
        return out_x, out_l, atn_sum, atn_vis[-1:, 0:1]

    # ------------------------------------------------------------------
    # reference encoding (reference generator.py:341-393)
    # ------------------------------------------------------------------
    def _n_pre(self) -> int:
        return min(self.cfg.n_downsample_A, self.nd) if self.cfg.n_shot > 1 else 0

    def _ref_encode_prefix(self, img_ref, label_ref):
        """Label-independent part of the reference encoding: first convs,
        downs up to the attention point, and the attention keys."""
        x = self.ref_img_first(img_ref)
        x_label = self.ref_label_first(label_ref)
        for i in range(self._n_pre()):
            x = getattr(self, f"ref_img_down_{i}")(x)
            x_label = getattr(self, f"ref_label_down_{i}")(x_label)
        key = None
        if self.cfg.n_shot > 1 and 1 <= self.cfg.n_downsample_A <= self.nd:
            key = self._attention_encode(label_ref, "key")
        return dict(x=x, x_label=x_label, key=key)

    def _reference_encoding(self, img_ref, label_ref, label, prefix=None):
        """img_ref / label_ref flattened to (B*K, C, H, W)."""
        cfg = self.cfg
        if prefix is None:
            prefix = self._ref_encode_prefix(img_ref, label_ref)
        x, x_label, key = prefix["x"], prefix["x_label"], prefix["key"]
        atn = atn_vis = ref_idx = None
        if cfg.n_shot > 1 and 1 <= cfg.n_downsample_A <= self.nd:
            x, x_label, atn, atn_vis = self._attention_module(
                x, x_label, label, label_ref, key=key)
            ref_idx = torch.argmax(atn, 1)
        for i in range(self._n_pre(), self.nd):
            x = getattr(self, f"ref_img_down_{i}")(x)
            x_label = getattr(self, f"ref_label_down_{i}")(x_label)

        enc_img, enc_label = [x], [x_label]
        for i in reversed(range(self.nd)):
            enc_img.append(getattr(self, f"ref_img_up_{i}")(enc_img[-1]))
            enc_label.append(getattr(self, f"ref_label_up_{i}")(enc_label[-1]))
        encoded_ref = []
        for conv, conv_label in zip(enc_img, enc_label):
            sm = torch.softmax(conv_label.float(), 1)
            # (b, i, j) = sum_hw conv[b, i] * softmax(label)[b, j]
            prod = torch.einsum("bihw,bjhw->bij", conv.float(), sm)
            encoded_ref.append(prod.to(conv.dtype))
        return x, encoded_ref[::-1], atn, atn_vis, ref_idx

    # ------------------------------------------------------------------
    # fc -> generated weights in the reference's flat-split order
    # (reference base_network.py:142-167)
    # ------------------------------------------------------------------
    def _run_fc(self, name, i, feat):
        """feat: (B, C, C) image-label outer product.  Returns the flat
        (B, C * fc_out) of the reference's fc(x).view(b, -1)."""
        b, rows, c = feat.shape
        return getattr(self, f"{name}_{i}")(feat.reshape(b * rows, c)).reshape(b, -1)

    def _get_spade_weights(self, feat, i):
        """Generated SPADE mlp and embedding weights for layer i, in torch
        layout (B, Cout, Cin, k, k).  The fc output is halved into gamma and
        beta chunks; each chunk's last `cout` elements (the reference's
        unused bias) are dropped."""
        cfg = self.cfg
        ch_in, ch_out = self.ch[i], self.ch[i + 1]
        ch_h = self.hidden_ncs(i)[0]
        sks, eks = cfg.spade_ks, cfg.embed_ks

        embedding_weights = None
        if self.adap_embed:
            fc_e = self._run_fc("fc_spade_e", i, feat)[:, :-ch_in]
            if ch_in != ch_out:
                embedding_weights = self._flat_to_conv_sized(fc_e, ch_in, ch_out, eks)
            else:  # the reference's reshape_weight takes its no-bias branch
                embedding_weights = (
                    fc_e.reshape(fc_e.shape[0], ch_in, ch_out, eks, eks), None)

        def pair(flat):
            half = flat.shape[1] // 2
            return flat[:, :half], flat[:, half:]

        def to_conv_nobias(flat, cout):
            return flat[:, :-cout].reshape(flat.shape[0], cout, ch_h, sks, sks)

        g0, b0 = pair(self._run_fc("fc_spade_0", i, feat))
        g1, b1 = pair(self._run_fc("fc_spade_1", i, feat))
        gs, bs = pair(self._run_fc("fc_spade_s", i, feat))
        return embedding_weights, [
            (to_conv_nobias(g0, ch_out), to_conv_nobias(b0, ch_out)),
            (to_conv_nobias(g1, ch_in), to_conv_nobias(b1, ch_in)),
            (to_conv_nobias(gs, ch_out), to_conv_nobias(bs, ch_out))]

    @staticmethod
    def _flat_to_conv_sized(flat, cout, cin, k):
        b = flat.shape[0]
        return flat[:, :-cout].reshape(b, cout, cin, k, k), flat[:, -cout:]

    # ------------------------------------------------------------------
    # weight generation (reference generator.py:396-422)
    # ------------------------------------------------------------------
    def weight_generation(self, img_refs, label_refs, label, prefix=None):
        """img_refs / label_refs: (B, K, C, H, W).  Returns (x, gen) with gen =
        dict(embedding_weights, norm_weights, atn, atn_vis, ref_idx)."""
        img_flat = img_refs.flatten(0, 1)
        label_flat = label_refs.flatten(0, 1)
        x, encoded_ref, atn, atn_vis, ref_idx = self._reference_encoding(
            img_flat, label_flat, label, prefix=prefix)
        embedding_weights, norm_weights = [], []
        if self.adap_spade:
            for i in range(self.n_adaptive):
                ew, nw = self._get_spade_weights(
                    encoded_ref[min(len(encoded_ref) - 1, i + 1)], i)
                embedding_weights.append(ew)
                norm_weights.append(nw)
        return x, dict(embedding_weights=embedding_weights,
                       norm_weights=norm_weights, atn=atn, atn_vis=atn_vis,
                       ref_idx=ref_idx)

    # ------------------------------------------------------------------
    # flow (reference generator.py:424-445)
    # ------------------------------------------------------------------
    def flow_generation(self, label, label_refs, img_refs, prev_label,
                        prev_img, ref_idx, warp_prev):
        cfg = self.cfg
        label_ref = pick_ref(label_refs, ref_idx)
        img_ref = pick_ref(img_refs, ref_idx)
        flow, flow_mask, img_warp, ds_ref = ([None, None] for _ in range(4))
        do_prev = warp_prev and prev_label is not None
        if (self.warp_ref and do_prev and cfg.flow_temp_is_shared
                and not self.training):
            # one network on same-shaped inputs: run ref and prev as one 2B
            # batch (at eval only: batch statistics would mix the two)
            b = label.shape[0]
            flow2, mask2 = self.flow_network_ref(
                torch.cat([label, label]), torch.cat([label_ref, prev_label]),
                torch.cat([img_ref, prev_img]))
            warp2 = flow_warp(torch.cat([img_ref[:, :3], prev_img[:, -3:]]), flow2)
            flow = [flow2[:b], flow2[b:]]
            flow_mask = [mask2[:b], mask2[b:]]
            img_warp = [warp2[:b], warp2[b:]]
        else:
            if self.warp_ref:
                flow[0], flow_mask[0] = self.flow_network_ref(label, label_ref, img_ref)
                img_warp[0] = flow_warp(img_ref, flow[0])[:, :3]
            if do_prev:
                flow[1], flow_mask[1] = self.flow_network_temp(
                    label, prev_label, prev_img)
                img_warp[1] = flow_warp(prev_img[:, -3:], flow[1])
        if cfg.spade_combine:
            if self.warp_ref:
                ds_ref[0] = torch.cat([img_warp[0], flow_mask[0]], 1)
            if do_prev:
                ds_ref[1] = torch.cat([img_warp[1], flow_mask[1]], 1)
        return flow, flow_mask, img_warp, ds_ref

    def _spade_combine(self, encoded_label, ds_ref):
        """Attach the warped-image embeddings as extra SPADE maps
        (reference generator.py:448-454)."""
        cfg = self.cfg
        if not cfg.spade_combine:
            return encoded_label
        if cfg.prev_embedding_is_shared and ds_ref[0] is not None and ds_ref[1] is not None:
            b = ds_ref[0].shape[0]
            both = self.img_ref_embedding(torch.cat([ds_ref[0], ds_ref[1]]))
            enc_ref = [e[:b] for e in both]
            enc_prev = [e[b:] for e in both]
        else:
            enc_ref = (self.img_ref_embedding(ds_ref[0])
                       if ds_ref[0] is not None else None)
            enc_prev = (self.img_prev_embedding(ds_ref[1])
                        if ds_ref[1] is not None else None)
        out = list(encoded_label)
        for i in range(cfg.n_sc_layers):
            out[i] = [encoded_label[i],
                      enc_ref[i] if enc_ref is not None else None,
                      enc_prev[i] if enc_prev is not None else None]
        return out

    # ------------------------------------------------------------------
    # main branch (reference generator.py:199-211)
    # ------------------------------------------------------------------
    def _main_branch(self, x, encoded_label, gen, raw_label=None):
        cfg = self.cfg
        add_raw = cfg.add_raw_output_loss and cfg.spade_combine
        x_raw = None
        for i in range(self.nd, -1, -1):
            nw = gen["norm_weights"][i] if self.adap_spade and i < self.n_adaptive else None
            block = getattr(self, f"up_{i}")
            if add_raw and i < cfg.n_sc_layers:
                if i == cfg.n_sc_layers - 1:
                    x_raw = x
                x_raw = block(x_raw, raw_label[i], nw)
                if i > 0:
                    x_raw = upsample_nearest(x_raw)
            x = block(x, encoded_label[i], nw)
            if i > 0:
                x = upsample_nearest(x)
        img = torch.tanh(self.conv_img(leaky_relu(x)))
        img_raw = (torch.tanh(self.conv_img(leaky_relu(x_raw)))
                   if x_raw is not None else None)
        return img, img_raw

    def _synthesize_from(self, x, gen, label, label_refs, img_refs,
                         prev_label, prev_img, warp_prev):
        cfg = self.cfg
        encoded_label = self.label_embedding(
            label, weights=gen["embedding_weights"] if self.adap_embed else None)
        flow, flow_mask, img_warp, ds_ref = self.flow_generation(
            label, label_refs, img_refs, prev_label, prev_img, gen["ref_idx"],
            warp_prev)
        raw_label = None
        if cfg.add_raw_output_loss and cfg.spade_combine:
            raw_label = encoded_label[:cfg.n_sc_layers]
        encoded_label = self._spade_combine(encoded_label, ds_ref)
        img_final, img_raw = self._main_branch(x, encoded_label, gen, raw_label)
        return img_final, img_raw, flow, flow_mask, img_warp

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def forward(self, label, label_refs, img_refs, prev_label=None,
                prev_img=None, warp_prev: bool = False, prefix=None):
        """Full forward (reference generator.py:181-229), at eval or, for
        K = 1, in train mode.

        label: (B, Cl, H, W); label_refs / img_refs: (B, K, C, H, W);
        prev_label / prev_img: previous frames stacked on channels, or None;
        prefix: the encode_reference_multi cache (K > 1).  Returns a dict with
        img_final, flow, flow_mask, img_raw, img_warp, atn_vis, ref_idx."""
        cfg = self.cfg
        if self.training and cfg.n_shot > 1:
            raise NotImplementedError(
                "train mode with n_shot > 1 is not ported: the attention "
                "kernel has no backward")
        x, gen = self.weight_generation(img_refs, label_refs, label, prefix=prefix)
        img_final, img_raw, flow, flow_mask, img_warp = self._synthesize_from(
            x, gen, label, label_refs, img_refs, prev_label, prev_img, warp_prev)
        if not cfg.spade_combine:
            if self.warp_ref:
                img_raw_out = img_final
                img_final = img_final * flow_mask[0] + img_warp[0] * (1 - flow_mask[0])
            else:
                img_raw_out = img_final if warp_prev else None
            if warp_prev and prev_label is not None:
                img_final = img_final * flow_mask[1] + img_warp[1] * (1 - flow_mask[1])
            img_raw = img_raw_out
        return dict(img_final=img_final, flow=flow, flow_mask=flow_mask,
                    img_raw=img_raw, img_warp=img_warp, atn_vis=gen["atn_vis"],
                    ref_idx=gen["ref_idx"])

    def encode_reference(self, label_refs, img_refs, label) -> Dict:
        """K = 1 serving cache: the bottleneck and the generated weights,
        which do not depend on the current label when K = 1."""
        self._check_eval()
        x, gen = self.weight_generation(img_refs, label_refs, label)
        return dict(x_kld=x, embedding_weights=gen["embedding_weights"],
                    norm_weights=gen["norm_weights"])

    def encode_reference_multi(self, label_refs, img_refs) -> Dict:
        """K > 1 serving cache: the label-independent encoder prefix and the
        attention keys; pass it as `prefix` to forward."""
        self._check_eval()
        return self._ref_encode_prefix(img_refs.flatten(0, 1),
                                       label_refs.flatten(0, 1))

    def synthesize(self, label, label_refs, img_refs, cache, prev_label=None,
                   prev_img=None, warp_prev: bool = False) -> Dict:
        """Per-frame K = 1 inference from an encode_reference cache."""
        self._check_eval()
        cfg = self.cfg
        gen = dict(embedding_weights=cache["embedding_weights"],
                   norm_weights=cache["norm_weights"], ref_idx=None)
        img_final, img_raw, flow, flow_mask, img_warp = self._synthesize_from(
            cache["x_kld"], gen, label, label_refs, img_refs, prev_label,
            prev_img, warp_prev)
        if not cfg.spade_combine:
            if self.warp_ref:
                img_final = img_final * flow_mask[0] + img_warp[0] * (1 - flow_mask[0])
            if warp_prev and prev_label is not None:
                img_final = img_final * flow_mask[1] + img_warp[1] * (1 - flow_mask[1])
        return dict(img_final=img_final, flow=flow, flow_mask=flow_mask,
                    img_raw=img_raw, img_warp=img_warp)
