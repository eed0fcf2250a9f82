"""How far one dropped 64-key tile moves the flash forward's o and lse at
the 32k prefill's length: ``flash_forward_plain`` over 256 query rows in
the middle and at the end of S 32768 (GQA 7/1, hd 128, bf16 inputs drawn
from a seed), against itself without keys 8192-8255.  The numbers size
``chip_smoke.check_flash_forward_long``'s bounds against such a fault.
Runs on the CPU (~30 s, ~2 GB):

    PYTHONPATH=src python tests/_flash_long_sensitivity.py
"""
import torch

from repro_torch.kernels import flash_attention as fa

S, H, HKV, HD, ROWS = 32768, 7, 1, 128, 256
DROP = slice(8192, 8256)


def main():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, h, S, HD, generator=gen).bfloat16()
               for h in (H, HKV, HKV))
    keep = torch.cat([torch.arange(0, DROP.start), torch.arange(DROP.stop, S)])
    n_drop = DROP.stop - DROP.start
    for r0 in (S // 2 - ROWS // 2, S - ROWS):
        q_s = q[:, :, r0:r0 + ROWS]
        o, lse = fa.flash_forward_plain(q_s, k, v, q_offset=r0,
                                        scale=HD ** -0.5)
        o_d, lse_d = fa.flash_forward_plain(q_s, k[:, :, keep], v[:, :, keep],
                                            q_offset=r0 - n_drop,
                                            scale=HD ** -0.5)
        d_o = (o_d.float() - o.float()).abs().max() / o.float().abs().max()
        d_l = (lse_d - lse).abs().max() / lse.abs().max()
        print(f"rows {r0}..{r0 + ROWS - 1}, keys {DROP.start}..{DROP.stop - 1}"
              f" dropped: o moves {d_o.item():.3g}, lse {d_l.item():.3g} of "
              f"their largest element")


if __name__ == "__main__":
    main()
