"""Few-shot adaptive-SPADE generator (port of
fsvid2vid_tpu/models/generator.py, reference models/networks/generator.py)
on (B, C, H, W) maps.  The layout follows the inputs: the serving pipeline
hands channels-last views to a module whose weights are channels-last, and
every stage keeps that layout (the warps, `cat_channels`, B1's tokens,
which are then a view, and its output, channels-last as it comes), so that
no convolution of a served step is wrapped in layout transposes.

Ported: the reference encoder with its K-reference attention, the weight
generation (fc stacks with the reference's flat-split order), the flow
branches, the SPADE-combine embeddings and the main branch, plus the two
serving caches (`encode_reference` for K = 1, `encode_reference_multi` for
K > 1), the VAE bottleneck (`use_kld`), reference labels concatenated to the
reference images (`use_label_ref='concat'`) beside the multiplied default,
and the face-refinement generator (`for_face`, `forward_face`).  The K > 1
attention follows the JAX package's rule: at eval with c <= 512 channels it
runs kernel B1 (ops/attention_kernel.py; on the card the hand-written CUDA
kernels, on the CPU their plain version); in train mode, which B1 cannot
serve because it has no backward, and at c > 512, it runs
`chunked_ref_attention` (ops/attention_kernel.py, B1's plain version), the
differentiable query-chunked softmax of the JAX module's non-flash branch.

`forward` follows `module.training`.  In train mode batch norms use batch
statistics and every spectral-norm layer advances its u / v once per call,
so a module that is called twice in one forward (the shared flow network,
the up blocks that also produce the raw output) advances twice, as in the
reference; at K > 1 the attention's key encoder runs once over the B·K
references and its query encoder once over the B targets.  With cfg.remat
the up blocks, the flow nets and the SC embedders are recomputed in the
backward instead of keeping their activations (models/remat.py).

The VAE bottleneck (`_compute_kld`) maps the encoded reference to
mu = fc_mu_ref(x) and back through `fc` (the reference's name for JAX's
fc_kld); in train mode z = eps exp(logvar / 2) + mu with the caller's eps
(training/step.py `with_vae_noise` draws it from a CPU torch.Generator, so
the card and the CPU draw the same z), at eval z = mu.  x is flattened
channel-last, the JAX package's order, so that its dense kernels carry over
by a transpose.

`for_face` builds the face refiner netGf (JAX `FewShotGenerator(...,
for_face=True)`): no flow branches, no SPADE-combine maps, no VAE layers, so
that it holds exactly the layers the JAX init of `forward_face` creates.

`adaptive_conv` generates the main-branch conv weights of the first
n_adaptive up blocks as well (`_get_conv_weights`, the `fc_conv_{0,1,s}_<i>`
stacks, fed the encoded reference one level below the SPADE weights'):
those blocks own no conv_0 / conv_1 / conv_s.  The shapes are the JAX
package's self-consistent ones, not the reference's.  The face refiner
with adaptive_conv fails in the JAX package and is refused
(models/face_refiner.py `check_refine_face`).
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
from fsvid2vid_tpu_torch.models.remat import remat
from fsvid2vid_tpu_torch.ops.attention_kernel import (MAX_C, chunked_ref_attention,
                                                       flash_ref_attention)
from fsvid2vid_tpu_torch.ops.image_ops import (adaptive_avg_pool, cat_channels, leaky_relu,
                                               upsample_nearest)
from fsvid2vid_tpu_torch.ops.warp import flow_warp
from fsvid2vid_tpu_torch.utils.profiling import span


def pick_ref(refs: torch.Tensor, ref_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """The most-attended reference of each sample (reference
    base_network.py:40-47).  refs: (B, K, C, H, W); ref_idx: (B,) or None
    for the first reference."""
    if ref_idx is None:
        return refs[:, 0]
    return refs[torch.arange(refs.shape[0], device=refs.device), ref_idx]


def roll_prevs(prevs: Dict[str, torch.Tensor], **new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The previous-frames ring advanced by one frame (reference
    vid2vid_model.py:203): each buffer prevs[key] stacks n_frames_G - 1
    channel-last frames along its last axis, oldest first; its oldest frame
    goes and new[key] comes last.  Returns the buffers named in `new`."""
    def roll(buf, frame):
        c = frame.shape[-1]
        if buf.shape[-1] == c:   # n_frames_G == 2: the buffer holds one frame
            return frame
        return torch.cat([buf[..., c:], frame], -1)
    return {key: roll(prevs[key], frame) for key, frame in new.items()}


# the VAE's latent size (reference generator.py:137) and the grid the fc
# stacks pool each reference feature map to under use_label_ref='concat'
Z_DIM = 256
FC_POOL = (32, 32)


class FewShotGenerator(nn.Module):
    def __init__(self, cfg: Config, for_face: bool = False):
        super().__init__()
        if cfg.use_label_ref not in ("mul", "concat"):
            raise NotImplementedError(
                f"use_label_ref={cfg.use_label_ref!r}: the port takes 'mul' or "
                "'concat'; 'concat,mul' fails in the JAX package itself "
                "(AttributeError: 'NoneType' object has no attribute 'shape'; "
                "ROADMAP.md C)")
        self.cfg = cfg
        self.for_face = for_face
        # the K > 1 attention at eval (B1); a check may swap in its plain
        # version.  Train mode takes chunked_ref_attention
        # with an energy of at most atn_chunk_elems elements per chunk (the
        # JAX module's attribute and default).
        self.attention = flash_ref_attention
        self.atn_chunk_elems = 1 << 23
        nd = cfg.n_downsample_G
        self.nd = nd
        self.ch = ch = channel_schedule(cfg.ngf, nd + 1, min(1024, cfg.ngf * 2 ** nd))
        self.adap_spade = cfg.adaptive_spade
        self.adap_conv = cfg.adaptive_conv
        self.adap_embed = cfg.adap_embed
        self.n_adaptive = cfg.n_adaptive
        self.warp_ref = cfg.warp_ref and not for_face
        self.mul_label_ref = cfg.use_label_ref == "mul"
        norm, norm_ref = cfg.norm_G, cfg.norm_G.replace("spade", "")
        # the face refiner takes the last three channels of the label crop
        label_nc = cfg.input_nc if for_face else cfg.gen_input_nc

        # --- reference encoder: reference labels are encoded beside the
        # images and multiplied in ('mul'), or concatenated to the images
        # ('concat') ---
        ref_nc = cfg.output_nc + (0 if self.mul_label_ref else label_nc)
        self.ref_img_first = SpadeConv2d(ref_nc, cfg.ngf, norm_ref)
        if self.mul_label_ref:
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
            if self.mul_label_ref:
                setattr(self, f"ref_label_down_{i}",
                        SpadeConv2d(ch[i], ch[i + 1], norm_ref, stride=2))
                setattr(self, f"ref_label_up_{i}",
                        SpadeConv2d(ch[i + 1], ch[i], norm_ref))

        # --- weight-generation fc stacks (reference generator.py:79-110);
        # 'mul' feeds them rows of the image-label outer product, 'concat'
        # each channel of the feature map pooled to FC_POOL.  The SPADE
        # stacks of level i read encoded level i + 1, the conv stacks level i ---
        if self.adap_spade or self.adap_conv:
            sks2, eks2, cks2 = cfg.spade_ks ** 2, cfg.embed_ks ** 2, cfg.conv_ks ** 2
            pooled = FC_POOL[0] * FC_POOL[1]
            for i in range(self.n_adaptive):
                ch_in, ch_out = ch[i], ch[i + 1]
                ch_h = self.hidden_ncs(i)[0]
                outs = []
                if self.adap_spade:
                    fc_in = ch[min(nd, i + 1)] if self.mul_label_ref else pooled
                    outs += [("fc_spade_0", fc_in, (ch_h * sks2 + 1) * 2),
                             ("fc_spade_1", fc_in,
                              (ch_h * sks2 + 1) * (1 if ch_in != ch_out else 2)),
                             ("fc_spade_s", fc_in, (ch_h * sks2 + 1) * 2)]
                    if self.adap_embed:
                        outs.append(("fc_spade_e", fc_in, ch_in * eks2 + 1))
                if self.adap_conv:
                    fc_in = ch[min(nd, i)] if self.mul_label_ref else pooled
                    outs += [("fc_conv_0", fc_in, ch_out * cks2 + 1),
                             ("fc_conv_1", fc_in, ch_in * cks2 + 1),
                             ("fc_conv_s", fc_in, ch_out + 1)]
                for name, fc_in, fc_out in outs:
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
                conv_params_free=self.adap_conv and i < self.n_adaptive,
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

        # --- VAE bottleneck (reference generator.py:137-144); the face
        # refiner encodes its coarse input instead and has none ---
        if cfg.use_kld and not for_face:
            sw = cfg.fine_size // 2 ** nd
            f_dim = min(1024, cfg.ngf * 2 ** nd) * int(sw / cfg.aspect_ratio) * sw
            self.fc_mu_ref = nn.Linear(f_dim, Z_DIM)
            self.fc_var_ref = nn.Linear(f_dim, Z_DIM)
            self.fc = nn.Linear(Z_DIM, f_dim)

        # --- flow branches (reference generator.py:146-179); a shared
        # network is registered under both names, as the reference does ---
        if self.warp_ref:
            self.flow_network_ref = FlowGenerator(cfg, 2)
            if cfg.spade_combine:
                self.img_ref_embedding = LabelEmbedder(
                    cfg.output_nc + 1, cfg.sc_arch, cfg.ngf, nd)
        if cfg.n_frames_G > 1 and not for_face:
            self.flow_network_temp = (
                self.flow_network_ref if cfg.flow_temp_is_shared
                else FlowGenerator(cfg, cfg.n_frames_G))
            if cfg.spade_combine:
                self.img_prev_embedding = (
                    self.img_ref_embedding if cfg.prev_embedding_is_shared
                    else LabelEmbedder(cfg.output_nc + 1, cfg.sc_arch,
                                       cfg.ngf, nd))

    def _call(self, module: nn.Module, *args):
        """module(*args), recomputed in the backward when cfg.remat is on and
        the module trains."""
        if self.training and self.cfg.remat:
            return remat(module, *args, modules=[module])
        return module(*args)

    def hidden_ncs(self, i: int) -> List[int]:
        """SPADE modulation-map channels at layer i: the label embedding's,
        and with spade_combine the two warped-image embeddings' (the face
        refiner modulates with the label alone)."""
        if self.cfg.spade_combine and i < self.cfg.n_sc_layers and not self.for_face:
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
        args = (tokens(query, b), tokens(key, bk), tokens(x, bk), lf, n)
        if self.training or c > MAX_C:
            # JAX's non-flash branch: train mode, and c beyond its flash limit
            out_x, out_l, vis = chunked_ref_attention(*args, self.atn_chunk_elems)
        else:
            out_x, out_l, vis = self.attention(*args)
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
        if self.mul_label_ref:
            x = self.ref_img_first(img_ref)
            x_label = self.ref_label_first(label_ref)
        else:
            x = self.ref_img_first(torch.cat([img_ref, label_ref], 1))
            x_label = None
        for i in range(self._n_pre()):
            x, x_label = self._ref_down(i, x, x_label)
        key = None
        if self.cfg.n_shot > 1 and 1 <= self.cfg.n_downsample_A <= self.nd:
            key = self._attention_encode(label_ref, "key")
        return dict(x=x, x_label=x_label, key=key)

    def _ref_down(self, i, x, x_label):
        x = getattr(self, f"ref_img_down_{i}")(x)
        if x_label is not None:
            x_label = getattr(self, f"ref_label_down_{i}")(x_label)
        return x, x_label

    def _reference_encoding(self, img_ref, label_ref, label, prefix=None):
        """img_ref / label_ref flattened to (B*K, C, H, W).  The encoded
        references are the image-label outer products (B, C, C) under 'mul',
        the image features (B, C, h, w) under 'concat'."""
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
            x, x_label = self._ref_down(i, x, x_label)

        enc_img = [x]
        for i in reversed(range(self.nd)):
            enc_img.append(getattr(self, f"ref_img_up_{i}")(enc_img[-1]))
        if not self.mul_label_ref:
            return x, enc_img[::-1], atn, atn_vis, ref_idx
        enc_label = [x_label]
        for i in reversed(range(self.nd)):
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
        """feat: (B, C, C) image-label outer product ('mul') or (B, C, h, w)
        features ('concat', each channel pooled to FC_POOL as torch's
        adaptive average pool buckets it).  Returns the flat
        (B, C * fc_out) of the reference's fc(x).view(b, -1)."""
        if not self.mul_label_ref:
            feat = adaptive_avg_pool(feat, FC_POOL).flatten(2)
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

    def _get_conv_weights(self, feat, i):
        """Generated main-branch conv weights of up block i (reference
        generator.py:276-289, with the JAX package's self-consistent shapes:
        conv_0 fin -> fhidden, conv_1 fhidden -> fout, conv_s 1 x 1).  Block
        i maps ch[i + 1] to ch[i], so with the encoder's names ch_in =
        ch[i], ch_out = ch[i + 1] each weight is (B, ch_in, Cin, k, k) with
        a bias (B, ch_in) cut from the end of its flat fc output."""
        ch_in, ch_out, k = self.ch[i], self.ch[i + 1], self.cfg.conv_ks
        return [self._flat_to_conv_sized(self._run_fc("fc_conv_0", i, feat), ch_in, ch_out, k),
                self._flat_to_conv_sized(self._run_fc("fc_conv_1", i, feat), ch_in, ch_in, k),
                self._flat_to_conv_sized(self._run_fc("fc_conv_s", i, feat), ch_in, ch_out, 1)]

    # ------------------------------------------------------------------
    # weight generation (reference generator.py:396-422)
    # ------------------------------------------------------------------
    def weight_generation(self, img_refs, label_refs, label, prefix=None,
                          img_coarse=None, vae_eps=None):
        """img_refs / label_refs: (B, K, C, H, W).  Returns (x, gen) with gen =
        dict(embedding_weights, norm_weights, conv_weights, atn, atn_vis,
        ref_idx, mu, logvar); x is the bottleneck after `_compute_kld`."""
        with span("fsv.gen.weights"):
            img_flat = img_refs.flatten(0, 1)
            label_flat = label_refs.flatten(0, 1)
            x, encoded_ref, atn, atn_vis, ref_idx = self._reference_encoding(
                img_flat, label_flat, label, prefix=prefix)
            x, mu, logvar = self._compute_kld(x, label, img_coarse, vae_eps)
            embedding_weights, norm_weights, conv_weights = [], [], []
            last = len(encoded_ref) - 1
            for i in range(self.n_adaptive):
                if self.adap_spade:
                    ew, nw = self._get_spade_weights(encoded_ref[min(last, i + 1)], i)
                    embedding_weights.append(ew)
                    norm_weights.append(nw)
                if self.adap_conv:
                    conv_weights.append(self._get_conv_weights(encoded_ref[min(last, i)], i))
        return x, dict(embedding_weights=embedding_weights,
                       norm_weights=norm_weights, conv_weights=conv_weights, atn=atn,
                       atn_vis=atn_vis, ref_idx=ref_idx, mu=mu, logvar=logvar)

    # ------------------------------------------------------------------
    # VAE bottleneck (reference generator.py:319-338)
    # ------------------------------------------------------------------
    def _compute_kld(self, x, label, img_coarse, vae_eps):
        """The bottleneck that the main branch starts from, with mu and
        logvar (None where the branch has none).  Face refinement encodes
        the coarse face (with its label under 'concat') through the
        reference image encoder; use_kld maps x through the VAE; else x."""
        if img_coarse is not None:
            if not self.mul_label_ref:
                img_coarse = torch.cat([img_coarse, label], 1)
            xk = self.ref_img_first(img_coarse)
            for i in range(self.nd):
                xk = getattr(self, f"ref_img_down_{i}")(xk)
            return xk, None, None
        if not self.cfg.use_kld:
            return x, None, None
        b, c, h, w = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(b, -1)
        mu = self.fc_mu_ref(flat)
        logvar = None
        if self.training:
            if vae_eps is None:
                raise ValueError("use_kld in train mode draws z = eps exp(logvar / 2) + mu: "
                                 "pass vae_eps (B, 256)")
            logvar = self.fc_var_ref(flat)
            z = vae_eps.to(device=mu.device, dtype=mu.dtype) * torch.exp(0.5 * logvar) + mu
        else:
            z = mu
        xk = self.fc(z).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return xk, mu, logvar

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
            flow2, mask2 = self._call(
                self.flow_network_ref, torch.cat([label, label]),
                torch.cat([label_ref, prev_label]), torch.cat([img_ref, prev_img]))
            warp2 = flow_warp(torch.cat([img_ref[:, :3], prev_img[:, -3:]]), flow2)
            flow = [flow2[:b], flow2[b:]]
            flow_mask = [mask2[:b], mask2[b:]]
            img_warp = [warp2[:b], warp2[b:]]
        else:
            if self.warp_ref:
                flow[0], flow_mask[0] = self._call(
                    self.flow_network_ref, label, label_ref, img_ref)
                img_warp[0] = flow_warp(img_ref, flow[0])[:, :3]
            if do_prev:
                flow[1], flow_mask[1] = self._call(
                    self.flow_network_temp, label, prev_label, prev_img)
                img_warp[1] = flow_warp(prev_img[:, -3:], flow[1])
        if cfg.spade_combine:
            if self.warp_ref:
                ds_ref[0] = cat_channels([img_warp[0], flow_mask[0]])
            if do_prev:
                ds_ref[1] = cat_channels([img_warp[1], flow_mask[1]])
        return flow, flow_mask, img_warp, ds_ref

    def _spade_combine(self, encoded_label, ds_ref):
        """Attach the warped-image embeddings as extra SPADE maps
        (reference generator.py:448-454)."""
        cfg = self.cfg
        if not cfg.spade_combine:
            return encoded_label
        if cfg.prev_embedding_is_shared and ds_ref[0] is not None and ds_ref[1] is not None:
            b = ds_ref[0].shape[0]
            both = self._call(self.img_ref_embedding, torch.cat([ds_ref[0], ds_ref[1]]))
            enc_ref = [e[:b] for e in both]
            enc_prev = [e[b:] for e in both]
        else:
            enc_ref = (self._call(self.img_ref_embedding, ds_ref[0])
                       if ds_ref[0] is not None else None)
            enc_prev = (self._call(self.img_prev_embedding, ds_ref[1])
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
            cw = gen["conv_weights"][i] if self.adap_conv and i < self.n_adaptive else None
            block = getattr(self, f"up_{i}")
            if add_raw and i < cfg.n_sc_layers:
                if i == cfg.n_sc_layers - 1:
                    x_raw = x
                x_raw = self._call(block, x_raw, raw_label[i], nw, cw)
                if i > 0:
                    x_raw = upsample_nearest(x_raw)
            x = self._call(block, x, encoded_label[i], nw, cw)
            if i > 0:
                x = upsample_nearest(x)
        img = torch.tanh(self.conv_img(leaky_relu(x)))
        img_raw = (torch.tanh(self.conv_img(leaky_relu(x_raw)))
                   if x_raw is not None else None)
        return img, img_raw

    def _synthesize_from(self, x, gen, label, label_refs, img_refs,
                         prev_label, prev_img, warp_prev):
        cfg = self.cfg
        with span("fsv.gen.main"):
            encoded_label = self.label_embedding(
                label, weights=gen["embedding_weights"] if self.adap_embed else None)
        with span("fsv.gen.flow"):
            flow, flow_mask, img_warp, ds_ref = self.flow_generation(
                label, label_refs, img_refs, prev_label, prev_img, gen["ref_idx"],
                warp_prev)
        with span("fsv.gen.main"):
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
                prev_img=None, warp_prev: bool = False, prefix=None,
                vae_eps: Optional[torch.Tensor] = None):
        """Full forward (reference generator.py:181-229), at eval or in train
        mode.

        label: (B, Cl, H, W); label_refs / img_refs: (B, K, C, H, W);
        prev_label / prev_img: previous frames stacked on channels, or None;
        prefix: the encode_reference_multi cache (K > 1); vae_eps: the
        VAE's noise (B, 256), needed in train mode with use_kld.  Returns a
        dict with img_final, flow, flow_mask, img_raw, img_warp, atn_vis,
        ref_idx, mu and logvar (use_kld; logvar in train mode only) and, at
        K > 1, atn: each reference's attention mass (B, K), whose argmax is
        ref_idx."""
        cfg = self.cfg
        x, gen = self.weight_generation(img_refs, label_refs, label, prefix=prefix,
                                        vae_eps=vae_eps)
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
                    ref_idx=gen["ref_idx"], atn=gen["atn"], mu=gen["mu"],
                    logvar=gen["logvar"])

    def forward_face(self, label, label_refs, img_refs, img_coarse):
        """The face refiner's forward (reference generator.py:232-242): the
        coarse face crop (B, 3, h, w), encoded by the reference image
        encoder, is the bottleneck, which the up blocks modulate with the
        face crop's label (B, 3, h, w) under weights generated from the
        reference crops (B, K, 3, h, w).  Returns the face residual."""
        x, gen = self.weight_generation(img_refs, label_refs, label, img_coarse=img_coarse)
        encoded_label = self.label_embedding(
            label, weights=gen["embedding_weights"] if self.adap_embed else None)
        for i in range(self.nd, -1, -1):
            nw = gen["norm_weights"][i] if self.adap_spade and i < self.n_adaptive else None
            x = self._call(getattr(self, f"up_{i}"), x, encoded_label[i], nw)
            if i > 0:
                x = upsample_nearest(x)
        return torch.tanh(self.conv_img(leaky_relu(x)))

    def encode_reference(self, label_refs, img_refs, label) -> Dict:
        """K = 1 serving cache: the bottleneck and the generated weights
        (SPADE, embedding and, with adaptive_conv, per level the three conv
        (weight, bias) pairs), which do not depend on the current label
        when K = 1."""
        self._check_eval()
        x, gen = self.weight_generation(img_refs, label_refs, label)
        return dict(x_kld=x, embedding_weights=gen["embedding_weights"],
                    norm_weights=gen["norm_weights"], conv_weights=gen["conv_weights"])

    def encode_reference_multi(self, label_refs, img_refs) -> Dict:
        """K > 1 serving cache: the label-independent encoder prefix and the
        attention keys; pass it as `prefix` to forward."""
        self._check_eval()
        with span("fsv.gen.weights"):
            return self._ref_encode_prefix(img_refs.flatten(0, 1),
                                           label_refs.flatten(0, 1))

    def synthesize(self, label, label_refs, img_refs, cache, prev_label=None,
                   prev_img=None, warp_prev: bool = False) -> Dict:
        """Per-frame K = 1 inference from an encode_reference cache."""
        self._check_eval()
        cfg = self.cfg
        gen = dict(embedding_weights=cache["embedding_weights"],
                   norm_weights=cache["norm_weights"],
                   conv_weights=cache["conv_weights"], ref_idx=None)
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
