"""The ResNet trunk's work, from its shapes.

``convs`` lists the residual stages' convolutions of one crop; ``stem`` and
``int8_layers`` give (operations, bytes) of the int8 trunk's two spans at
``n`` crops, with the bytes each must move: every input read once and every
output written once, in the dtypes of the static int8 path (copied from the
port's ``conv_cost`` and ``stem_cost``, which ``chip_smoke.py`` divides by
the same peaks):

  * the input of layer1's first block is quantized once (bf16 read, int8
    written); each conv then reads its int8 input, its int8 weights
    (Cout × k²·Cin) and two float32 vectors (multiplier and bias);
  * a projection writes its bf16 output; conv1 and conv2 write int8 (the
    next conv's input, quantized in the epilogue); conv3 reads the bf16
    shortcut and writes the bf16 block output and its int8 for the next
    block (bf16 alone after the last block);
  * the per-conv multipliers xs·ws are one pass over the weight scales;
  * the global average pool reads the last bf16 map and writes the
    float32 features.

Operations are 2 per multiply-add.
"""

from typing import Dict, List, Mapping, Tuple


def _out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def stem_size(trunk: Mapping, crop: int) -> Tuple[int, int]:
    """(conv map side, pooled map side) of a square crop."""
    conv = _out(crop, trunk["stem_kernel"], 2)
    return conv, _out(conv, 3, 2)


def convs(trunk: Mapping, crop: int) -> List[Dict]:
    """The residual stages' convolutions of one crop, in the order they
    run: name, k, stride, cin, cout, input side, output side."""
    out, side = [], stem_size(trunk, crop)[1]
    inplanes = trunk["stem_width"]
    for s, (planes, blocks) in enumerate(zip(trunk["widths"], trunk["blocks"]), start=1):
        width = planes * trunk["expansion"]
        for b in range(blocks):
            stride = 2 if (s > 1 and b == 0) else 1
            o = _out(side, 3, stride)
            name = f"layer{s}_{b}"
            if b == 0:
                out.append(dict(name=f"{name}/proj", k=1, stride=stride, cin=inplanes,
                                cout=width, side_in=side, side_out=o))
            out += [dict(name=f"{name}/conv1", k=1, stride=1, cin=inplanes, cout=planes,
                         side_in=side, side_out=side),
                    dict(name=f"{name}/conv2", k=3, stride=stride, cin=planes, cout=planes,
                         side_in=side, side_out=o),
                    dict(name=f"{name}/conv3", k=1, stride=1, cin=planes, cout=width,
                         side_in=o, side_out=o)]
            inplanes, side = width, o
    return out


def conv_macs(c: Mapping) -> int:
    """Multiply-adds of one conv of one crop."""
    return c["side_out"] ** 2 * c["k"] ** 2 * c["cin"] * c["cout"]


def stem_macs(trunk: Mapping, crop: int) -> int:
    conv = stem_size(trunk, crop)[0]
    return conv * conv * trunk["stem_width"] * 3 * trunk["stem_kernel"] ** 2


def stem(trunk: Mapping, crop: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of the int8 trunk's stem at ``n`` crops: the
    folded bf16 conv, max-pool, bias and relu; float32 crops in, the pooled
    bf16 map out."""
    pooled = stem_size(trunk, crop)[1]
    c, k = trunk["stem_width"], trunk["stem_kernel"]
    n_bytes = (n * crop * crop * 3 * 4 + c * 3 * k * k * 2 + c * 4
               + n * pooled * pooled * c * 2)
    return 2.0 * n * stem_macs(trunk, crop), float(n_bytes)


def int8_layers(trunk: Mapping, crop: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of the ``int8_layers`` span at ``n`` crops."""
    cs = convs(trunk, crop)
    side0 = stem_size(trunk, crop)[1]
    n_bytes = n * side0 * side0 * trunk["stem_width"] * (2 + 1)     # quantize the stem map
    n_bytes += sum(c["cout"] * 4 * 2 for c in cs)                   # multipliers xs·ws
    ops = 0
    last = cs[-1]["name"]
    for c in cs:
        m = n * c["side_out"] ** 2
        ops += 2 * m * c["k"] ** 2 * c["cin"] * c["cout"]
        n_bytes += n * c["side_in"] ** 2 * c["cin"]                 # int8 input
        n_bytes += c["cout"] * c["k"] ** 2 * c["cin"] + 8 * c["cout"]
        kind = c["name"].split("/")[1]
        if kind == "proj":
            n_bytes += m * c["cout"] * 2
        elif kind in ("conv1", "conv2"):
            n_bytes += m * c["cout"]
        else:
            n_bytes += m * c["cout"] * 2                            # the bf16 shortcut
            n_bytes += m * c["cout"] * (2 if c["name"] == last else 3)
    side = cs[-1]["side_out"]
    width = cs[-1]["cout"]
    n_bytes += n * side * side * width * 2 + n * width * 4          # the pool
    return float(ops), float(n_bytes)


def trunk_macs(trunk: Mapping, crop: int) -> Tuple[int, int]:
    """(stem multiply-adds, residual stages' multiply-adds) of one crop."""
    return stem_macs(trunk, crop), sum(conv_macs(c) for c in convs(trunk, crop))
