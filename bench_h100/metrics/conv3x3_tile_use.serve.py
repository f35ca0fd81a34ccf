"""``conv3x3_tile_use.serve``: the share of the products that the 3x3
kernel's launched tiles span which are the convolutions' own, in %: the
program's counters ``conv3x3.flop`` (2 B H W Cout 9 Cin a launch) over
``conv3x3.tile_flop`` (2 B ceil(HW / 256) 256 ceil(Cout / 64) 64 K a
launch; ``ops/conv3x3.products``), summed over every launch of the run.
A tile's 256 pixels never span two images, so planes of under 256
pixels leave most of a tile empty.  None where the program has no such
counters or launched no tile, as a program without the kernel or off the
card gives."""


def read(run):
    if run.info.get('kind') != 'serve':
        return None
    from sed_tpu_torch.ops.conv3x3 import conv3x3
    flop = getattr(conv3x3, 'flop', 0)
    tiles = getattr(conv3x3, 'tile_flop', 0)
    return 100.0 * flop / tiles if tiles else None
