"""Device compute path: batched ALAC decode in JAX/XLA and Pallas (Triton).

The bit-serial decode of one packet cannot be parallelized (each Golomb
codeword's length depends on its decoded value — reference OPTIM.md:114), so
the device path parallelizes across packets: a batch of B packets decodes in
lockstep, one packet per lane, with per-lane bit cursors, adaptive-mean state and
LPC coefficient state held in registers.

Pipeline (see SURVEY §7):
  1. walk.py      — element walk + header parse + entropy decode (serial per
                    packet, vectorized over lanes)
  2. lpc.py       — adaptive LPC reconstruction (serial over samples,
                    vectorized over (packet, channel) lanes)
  3. epilogue.py  — escape extraction, shift-buffer reinsert, stereo unmix,
                    channel remap, bit-depth formatting (fully parallel)
  4. batch.py     — orchestration + host byte packing + scalar fallback
"""
