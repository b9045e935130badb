"""Where the OCR megastep kernel and its plain version part, stage by stage.

    python3 megastep_parts.py

For the cases of tests/test_torch_kernels_cuda.py::test_megastep_matches_plain
(its seeded inputs: d_model 192, rings of 256, p = 1 and 150), runs the
kernel over layer 0 and over layers 0-1, and reads its scratch: the last
layer's float32 x and qkv and its bf16 attn and mid. Each stage of that
layer is then recomputed from the kernel's own input to the stage, and the
values that differ are counted: qkv (RMSNorm, QKV GEMV), attn (RoPE, K/V
quantisation, ring attention), mid (O GEMV and residual, RMSNorm, gate / up
GEMV, SwiGLU) and x (the O and down GEMVs and residuals, from the kernel's
attn and mid). Each stage both as
`plain_megastep` takes it (the kernel's accumulation order and rounding)
and `rn`: round-to-nearest float32 matmuls and torch's own reductions. Also
the two-layer step's layer-1 K/V scales against plain_megastep's, which the
test holds to rtol 1e-3. Prints the card's name and power limit first.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke

CASES = [(b, heads, groups, d, pos)
         for b, heads, groups, d in ((3, 6, 2, 32), (16, 6, 2, 32),
                                     (24, 6, 2, 32), (48, 6, 2, 32),
                                     (50, 6, 2, 32), (8, 15, 5, 64),
                                     (5, 6, 2, 8))
         for pos in (1, 150)]
EPS = 1e-5


def scratch(x, rings, w, rope, pos, heads, groups):
    """The kernel's step (rings written in place at pos); its scratch's
    float32 x and qkv and bf16 attn and mid of the last layer."""
    import torch

    from markushgrapher_torch.ops import _build, megastep as ms

    dims = ms._check(x, rings, w, rope, pos, heads, groups)
    b, dm, f = dims["B"], dims["Dm"], dims["F"]
    nqkv, dq = w["wqkv"].shape[1], heads * dims["D"]
    ntsp = -(-dm // 64) * 4
    buf = torch.empty(64 + b * (dm + ntsp + nqkv) + b * (dq + f + 16) // 2,
                      dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    tensors = [x, out, buf, rope, *(rings[k] for k in
               ("k_q", "k_s", "v_q", "v_s")), *(w[k] for k in ms._WEIGHTS)]
    rc = _build.lib().mg_ocr_megastep(
        *(t.data_ptr() for t in tensors),
        *(dims[k] for k in ("L", "B", "S", "Dm", "H", "G", "D", "F")), pos,
        EPS, dims["D"] ** -0.5, _build.stream(out))
    _build.check(rc, "ocr_megastep")
    torch.cuda.synchronize()
    xs = buf[64:64 + b * dm].view(b, dm)
    at = 64 + b * (dm + ntsp)
    qkv = buf[at:at + b * nqkv].view(b, nqkv)
    halves = buf[at + b * nqkv:].view(torch.bfloat16)
    attn = halves[:b * (dq + 8)].view(b, dq + 8)[:, :dq].float()
    mid = halves[b * (dq + 8):b * (dq + 8 + f + 8)].view(b, f + 8)[:, :f]
    return xs.clone(), qkv.clone(), attn, mid.float()


def rms_rn(x, w, eps):
    import torch

    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(torch.bfloat16).float()


def attention_rn(qs, kr, vr, ks, vs, kdq, vdq):
    import torch

    s = torch.einsum("bhd,bkhd->bhk", qs, kr) * ks
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    pv = (e * vs).to(torch.bfloat16).float()
    acc = torch.einsum("bhk,bkhd->bhd", pv, vr)
    s_new = (qs * kdq).sum(dim=-1, keepdim=True)
    m_new = torch.maximum(m, s_new)
    alpha, p_new = torch.exp(m - m_new), torch.exp(s_new - m_new)
    den = e.sum(dim=-1, keepdim=True) * alpha + p_new
    return (acc * alpha + p_new * vdq) / den.clamp(min=1e-30)


def stages(x_in, kern, rings, w, layer, pos, heads, groups, rope):
    """{mode: {stage: values differing from the kernel's}}, each stage fed
    the kernel's own input."""
    import torch

    from markushgrapher_torch.ops import megastep as ms

    xs_k, qkv_k, attn_k, mid_k = kern
    wl = {k: t[layer] for k, t in w.items()}
    b, d = x_in.shape[0], wl["wo"].shape[1] // heads
    dq, dkv, f = heads * d, groups * d, wl["wd"].shape[1]
    hm = torch.arange(heads, device=x_in.device) // (heads // groups)
    cos, sin = ms.rope_rows(rope, pos)
    q = ms._rope(qkv_k[:, :dq].reshape(b, heads, d), cos, sin)
    k = ms._rope(qkv_k[:, dq:dq + dkv].reshape(b, groups, d), cos, sin)
    kdq, vdq = (ms._quantize(t)[2] for t in
                (k, qkv_k[:, dq + dkv:].reshape(b, groups, d)))
    qs = ms._bf16(q * d ** -0.5)
    ring = [rings[n][layer, :, :pos].float().reshape(b, pos, groups, d)
            [:, :, hm] for n in ("k_q", "v_q")]
    scales = [rings[n][layer, :, :, :pos][:, hm] for n in ("k_s", "v_s")]
    out = {}
    for mode in ("plain", "rn"):
        rms = ms._rms if mode == "plain" else rms_rn
        dot = ms._tc_dot if mode == "plain" else \
            (lambda h, wt: h @ wt.float().T)
        att = ms._ring_attention if mode == "plain" else attention_rn
        qkv = dot(rms(x_in, wl["ln_attn"], EPS), wl["wqkv"]) * wl["sqkv"]
        attn = ms._bf16(att(qs, *ring, *scales, kdq[:, hm], vdq[:, hm]))
        xm = x_in + dot(attn_k, wl["wo"]) * wl["so"]
        g, u = (dot(rms(xm, wl["ln_mlp"], EPS), wl["wgu"]) * wl["sgu"]) \
            .split(f, dim=-1)
        mid = ms._bf16(torch.sigmoid(g) * g * u)
        x_out = xm + dot(mid_k, wl["wd"]) * wl["sd"]
        out[mode] = {
            "qkv": int((qkv != qkv_k).sum()),
            "attn": int((attn.reshape(b, dq) != attn_k).sum()),
            "mid": int((mid != mid_k).sum()),
            "x": int((x_out != xs_k).sum())}
    sizes = {"qkv": qkv_k.numel(), "attn": attn_k.numel(),
             "mid": mid_k.numel(), "x": xs_k.numel()}
    return out, sizes


def main() -> None:
    import torch

    from markushgrapher_torch.ocr.vlm import rope_frequencies
    from markushgrapher_torch.ops import _build, megastep as ms

    if not torch.cuda.is_available():
        raise SystemExit("megastep_parts: needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_kernels_cuda import _mega_inputs

    print(chip_smoke.gpu_line(), flush=True)
    _build.lib()
    dev = torch.device("cuda")
    for batch, heads, groups, d, pos in CASES:
        x, rings, w = _mega_inputs(dev, 2, batch, 192, heads, groups, d,
                                   256, 256, pos, 7)
        rope = rope_frequencies(d, 512, 1e5).to(dev)
        layer0 = {k: t[0:1] for k, t in w.items()}
        one = scratch(x, {k: t[0:1].clone() for k, t in rings.items()},
                      layer0, rope, pos, heads, groups)
        rk = {k: t.clone() for k, t in rings.items()}
        two = scratch(x, rk, w, rope, pos, heads, groups)
        rp = {k: t.clone() for k, t in rings.items()}
        ms.plain_megastep(x, rp, w, rope, pos, heads=heads, groups=groups,
                          rms_eps=EPS)
        scale = max(float(((rk[n][1, :, :, pos] - rp[n][1, :, :, pos]).abs()
                           / rp[n][1, :, :, pos].abs()).max())
                    for n in ("k_s", "v_s"))
        for layer, x_in, kern in ((0, x.float(), one), (1, one[0], two)):
            diff, sizes = stages(x_in, kern, rings, w, layer, pos, heads,
                                 groups, rope)
            parts = ", ".join(f"{s} {diff['plain'][s]} ({diff['rn'][s]} rn) "
                              f"of {n}" for s, n in sizes.items())
            print(f"B={batch} H={heads} G={groups} D={d} p={pos} layer "
                  f"{layer}: values differing from the kernel's: {parts}",
                  flush=True)
        print(f"B={batch} H={heads} G={groups} D={d} p={pos}: two-layer "
              f"step, layer-1 K/V scales max rel {scale:.3e} from "
              f"plain_megastep's", flush=True)


if __name__ == "__main__":
    main()
