"""A plain-torch model of the staged ``client_step`` kernel's arithmetic
(``src/repro_torch/csrc/client_step.cu``), operation for operation: lane t
of the client's 32 W threads holds features F t .. F t + F - 1, each row's
dot product is summed over them in order, then across the warp by the
kernel's reduce-scatter, then across the W warps in order; each lane adds
its residual terms to its gradient row by row.  Torch only, so
both the CPU tests (against the JAX package,
``tests/test_torch_client_step.py``) and the card tests (against the
kernel, ``tests/test_torch_gpu.py``) can import it; it holds no tests.
"""
import torch


def reduce_scatter(v):
    """The warp reduce-scatter of ``csrc/client_step.cu`` on a [32, G]
    float32 tensor of per-lane values: row sums [G], each read at the lane
    the kernel reads it from (lane i * 32 / G)."""
    G = v.shape[1]
    lane = torch.arange(32)
    n, off = G, 16
    while off:
        partner = lane ^ off
        if n > 1:
            half = n // 2
            upper = ((lane & off) != 0)[:, None]
            send = torch.where(upper, v[:, :half], v[:, half:n])
            keep = torch.where(upper, v[:, half:n], v[:, :half])
            v = keep + send[partner]
            n = half
        else:
            v = v + v[partner]
        off //= 2
    return v[torch.arange(G) * (32 // G), 0]


def staged_model(xs, ys, slots, idx, w, bias, lr, H, b, mask, G):
    """The staged kernel's arithmetic, operation for operation, in float32
    torch (no contraction: the kernel is built with --fmad=false), in
    groups of G rows (the kernel's ``staging_plan`` picks G)."""
    xs, ys, w = (torch.as_tensor(a) for a in (xs, ys, w))
    C, D = len(slots), xs.shape[-1]
    W = -(-D // 128)
    T = 32 * W
    F = -(-D // T)
    d = F * torch.arange(T)[:, None] + torch.arange(F)[None, :]   # [T, F]
    valid = d < D
    dc = d.clamp(max=D - 1)
    lr = torch.tensor(lr, dtype=torch.float32)
    two_over_b = torch.tensor(2.0, dtype=torch.float32) / b
    zero = torch.zeros((), dtype=torch.float32)
    w_out, b_out, l_out = [], [], []   # lane t holds features F t .. F t + F-1
    for c in range(C):
        wl = torch.where(valid, w[dc], zero)
        bc = torch.tensor(bias, dtype=torch.float32)
        lsum, asum = zero.clone(), zero.clone()
        for h in range(H):
            r = torch.as_tensor(idx[c, h * b:(h + 1) * b]).long()
            xb, yb = xs[int(slots[c])][r], ys[int(slots[c])][r]
            g = torch.zeros((T, F), dtype=torch.float32)
            esum, e2 = zero.clone(), zero.clone()
            for j0 in range(0, b, G):
                rows = [torch.where(valid, xb[j][dc], zero) if j < b else
                        torch.zeros((T, F)) for j in range(j0, j0 + G)]
                xg = torch.stack(rows, dim=1)                 # [T, G, F]
                p = torch.zeros((T, G), dtype=torch.float32)
                for f in range(F):
                    p = p + xg[:, :, f] * wl[:, f][:, None]
                if W == 1:
                    dot = reduce_scatter(p)
                else:        # the lane of each row sums the warps in order
                    dot = torch.zeros(G, dtype=torch.float32)
                    for q in range(W):
                        dot = dot + reduce_scatter(p[32 * q:32 * (q + 1)])
                for i in range(G):
                    if j0 + i < b:
                        e = dot[i] + bc - yb[j0 + i]
                        esum = esum + e
                        e2 = e2 + e * e
                        g = g + e * xg[:, i]
            active = 1.0 if mask is None else float(mask[c, h])
            if active > 0:
                wl = wl - lr * (two_over_b * g)
                bc = bc - lr * (two_over_b * esum)
            lsum = lsum + (e2 / b) * active
            asum = asum + active
        w_out.append(wl[valid.nonzero(as_tuple=True)][torch.argsort(
            d[valid])])
        b_out.append(bc)
        l_out.append(lsum / torch.clamp(asum, min=1.0))
    return torch.stack(w_out), torch.stack(b_out), torch.stack(l_out)
