"""Convert a reference torch checkpoint (.pth) to the port's parameter
pickle: a copy of `tools/convert_checkpoint.py`, held equal to it by a
test.

Maps the reference's module names (`SingleStageSparse3DDetector` with
`MEResNet3D` + `Fcaf3DNeckWithHead`, MinkowskiEngine kernels of shape
[K^3, Cin, Cout]; VoteNet-v2; ImVoteNet's point and image towers) onto
the flax-layout `{"params", "batch_stats"}` numpy trees that
`init_detector` / `init_votenet` / `init_imvotenet(params_file=)` read
(`params.load_variables` raises unless every name and shape matches), and
reorders kernel offsets from ME's region enumeration into the framework's
`kernel_offsets` order (itertools.product, x slowest).

ME's hypercube region iterates the FIRST coordinate fastest (odometer over
dims in order), i.e. x fastest: the exact inverse of our ordering, so the
permutation is a transpose of the (3,3,3) offset grid. Verify converted
checkpoints by mAP before trusting them (`--offset-order` overrides).

    python -m fcaf3d_tpu_torch.tools.convert_checkpoint --pth epoch_12.pth \
        --out params.pkl [--model fcaf3d|votenet|imvotenet] [--depth 34]

Conversion runs on the host (numpy); no model is built.
"""
import argparse
import pickle

import numpy as np


def me_offset_permutation(kernel_size: int, order: str = "x_fastest"):
    """Permutation p with ours[i] = theirs[p[i]] for K^3 offsets."""
    k = kernel_size
    n = k ** 3
    if order == "x_slowest":  # already ours
        return np.arange(n)
    # ME x-fastest: their index = x + k*y + k*k*z ; our index = k*k*x + k*y
    # + z. ours[i] = theirs[p[i]], so p re-encodes our (x, y, z) with THEIR
    # strides (`z + k*y + k*k*x` would be the identity; an impulse through
    # the sparse conv tells the two apart).
    ours = np.arange(n)
    x, rem = ours // (k * k), ours % (k * k)
    y, z = rem // k, rem % k
    return x + k * y + k * k * z


def convert(state_dict: dict, n_resnet_layers=(3, 4, 6, 3), n_levels: int = 4,
            offset_order: str = "x_fastest"):
    """Returns {"params": tree, "batch_stats": tree} (nested dicts)."""

    def t2n(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    sd = {k: t2n(v) for k, v in state_dict.items()}
    p27 = me_offset_permutation(3, offset_order)
    p8 = me_offset_permutation(2, offset_order)

    params, stats = {}, {}

    def put(tree, path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def conv_kernel(src, perm):
        w = sd[src]
        assert w.ndim == 3, (src, w.shape)
        if w.shape[0] in (8, 27):
            w = w[perm if w.shape[0] == 27 else p8]
        return w.astype(np.float32)

    def bn(src_prefix, dst_path):
        put(params, dst_path + ("scale",), sd[f"{src_prefix}.weight"])
        put(params, dst_path + ("bias",), sd[f"{src_prefix}.bias"])
        put(stats, dst_path + ("mean",), sd[f"{src_prefix}.running_mean"])
        put(stats, dst_path + ("var",), sd[f"{src_prefix}.running_var"])

    # ---- backbone stem: conv1 Sequential(conv, InstanceNorm, ReLU, pool)
    put(params, ("backbone", "conv1", "kernel"),
        conv_kernel("backbone.conv1.0.kernel", p27))
    put(params, ("backbone", "norm1", "scale"), sd["backbone.conv1.1.weight"])
    put(params, ("backbone", "norm1", "bias"), sd["backbone.conv1.1.bias"])

    # ---- backbone stages
    for i, n_blocks in enumerate(n_resnet_layers[:n_levels]):
        for j in range(n_blocks):
            src = f"backbone.layer{i + 1}.{j}"
            dst = ("backbone", f"layer{i + 1}_{j}")
            put(params, dst + ("conv1", "kernel"),
                conv_kernel(f"{src}.conv1.kernel", p27))
            bn(f"{src}.norm1", dst + ("norm1",))
            put(params, dst + ("conv2", "kernel"),
                conv_kernel(f"{src}.conv2.kernel", p27))
            bn(f"{src}.norm2", dst + ("norm2",))
            if f"{src}.downsample.0.kernel" in sd:
                put(params, dst + ("downsample_conv", "kernel"),
                    conv_kernel(f"{src}.downsample.0.kernel", p27))
                bn(f"{src}.downsample.1.bn", dst + ("downsample_norm",))

    # ---- neck
    h = "neck_with_head"
    for i in range(1, n_levels):
        src = f"{h}.up_block_{i}"
        dst = ("neck_with_head",)
        put(params, dst + (f"up_block_{i}_tr", "kernel"),
            conv_kernel(f"{src}.0.kernel", p27))
        bn(f"{src}.1.bn", dst + (f"up_block_{i}_bn1",))
        put(params, dst + (f"up_block_{i}_conv", "kernel"),
            conv_kernel(f"{src}.3.kernel", p27))
        bn(f"{src}.4.bn", dst + (f"up_block_{i}_bn2",))
    for i in range(n_levels):
        src = f"{h}.out_block_{i}"
        put(params, ("neck_with_head", f"out_block_{i}_conv", "kernel"),
            conv_kernel(f"{src}.0.kernel", p27))
        bn(f"{src}.1.bn", ("neck_with_head", f"out_block_{i}_bn"))

    # ---- head convs + per-level scales
    for name in ("centerness_conv", "reg_conv", "cls_conv"):
        put(params, ("neck_with_head", name, "kernel"),
            conv_kernel(f"{h}.{name}.kernel", p27))
    put(params, ("neck_with_head", "cls_conv", "bias"), sd[f"{h}.cls_conv.bias"])
    for i in range(n_levels):
        put(params, ("neck_with_head", f"scale_{i}"),
            sd[f"{h}.scales.{i}.scale"].reshape(()))

    return {"params": params, "batch_stats": stats}


def _mk_put(params, stats):
    def put(tree, path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    return put


def _dense_from_conv(w):
    """torch Conv1d/Conv2d 1x1 weight [out, in, 1(, 1)] -> flax Dense kernel
    [in, out]."""
    w = np.asarray(w)
    while w.ndim > 2:
        assert w.shape[-1] == 1, w.shape
        w = w[..., 0]
    return np.ascontiguousarray(w.T.astype(np.float32))


def convert_votenet(state_dict: dict, head_prefix: str = "bbox_head",
                    backbone_prefix: str = "backbone",
                    n_sa: int = 4, n_fp: int = 2):
    """Convert a reference VoteNet-v2 checkpoint (`vote_head_v2.py`,
    `pointnet2_sa_ssg.py`) to this framework's `VoteNet` flax trees.

    Name map (reference -> framework):
      {bb}.SA_modules.{i}.mlps.0.layer{j}.{conv,bn} -> backbone/sa{i}/mlp{j}
      {bb}.FP_modules.{i}.mlps.layer{j}.*          -> backbone/fp{i}/mlp{j}
      {hd}.vote_module.vote_conv.{i}.*             -> vote_module/vote_conv{i}
      {hd}.vote_module.conv_out.*                  -> vote_module/conv_out
      {hd}.vote_aggregation.mlps.0.layer{j}.*      -> vote_aggregation/mlp{j}
      {hd}.conv_pred.shared_convs.layer{i}.*       -> shared_conv{i}
      {hd}.conv_pred.conv_{cls,reg}.*              -> conv_{cls,reg}
    ConvModule convs carry no bias (BN follows) -> framework Dense biases
    are zeroed. 1x1 convs transpose to Dense kernels; no offset reordering
    (no sparse kernels here).
    """

    def t2n(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    sd = {k: t2n(v) for k, v in state_dict.items()}
    params, stats = {}, {}
    put = _mk_put(params, stats)

    def dense_bn(src, dst, conv_key="conv.weight", bn_key="bn"):
        w = _dense_from_conv(sd[f"{src}.{conv_key}"])
        put(params, dst + ("Dense_0", "kernel"), w)
        bias = sd.get(f"{src}.conv.bias")
        put(params, dst + ("Dense_0", "bias"),
            bias.astype(np.float32) if bias is not None
            else np.zeros(w.shape[1], np.float32))
        put(params, dst + ("BatchNorm_0", "scale"), sd[f"{src}.{bn_key}.weight"])
        put(params, dst + ("BatchNorm_0", "bias"), sd[f"{src}.{bn_key}.bias"])
        put(stats, dst + ("BatchNorm_0", "mean"),
            sd[f"{src}.{bn_key}.running_mean"])
        put(stats, dst + ("BatchNorm_0", "var"),
            sd[f"{src}.{bn_key}.running_var"])

    bb, hd = backbone_prefix, head_prefix
    for i in range(n_sa):
        j = 0
        while f"{bb}.SA_modules.{i}.mlps.0.layer{j}.conv.weight" in sd:
            dense_bn(f"{bb}.SA_modules.{i}.mlps.0.layer{j}",
                     ("backbone", f"sa{i}", f"mlp{j}"))
            j += 1
        assert j > 0, f"no SA mlp layers found under {bb}.SA_modules.{i}"
    for i in range(n_fp):
        j = 0
        while f"{bb}.FP_modules.{i}.mlps.layer{j}.conv.weight" in sd:
            dense_bn(f"{bb}.FP_modules.{i}.mlps.layer{j}",
                     ("backbone", f"fp{i}", f"mlp{j}"))
            j += 1
        assert j > 0, f"no FP mlp layers found under {bb}.FP_modules.{i}"

    i = 0
    while f"{hd}.vote_module.vote_conv.{i}.conv.weight" in sd:
        dense_bn(f"{hd}.vote_module.vote_conv.{i}",
                 ("vote_module", f"vote_conv{i}"))
        i += 1
    put(params, ("vote_module", "conv_out", "kernel"),
        _dense_from_conv(sd[f"{hd}.vote_module.conv_out.weight"]))
    put(params, ("vote_module", "conv_out", "bias"),
        sd[f"{hd}.vote_module.conv_out.bias"].astype(np.float32))

    j = 0
    while f"{hd}.vote_aggregation.mlps.0.layer{j}.conv.weight" in sd:
        dense_bn(f"{hd}.vote_aggregation.mlps.0.layer{j}",
                 ("vote_aggregation", f"mlp{j}"))
        j += 1
    i = 0
    while f"{hd}.conv_pred.shared_convs.layer{i}.conv.weight" in sd:
        dense_bn(f"{hd}.conv_pred.shared_convs.layer{i}", (f"shared_conv{i}",))
        i += 1
    for name in ("cls", "reg"):
        put(params, (f"conv_{name}", "kernel"),
            _dense_from_conv(sd[f"{hd}.conv_pred.conv_{name}.weight"]))
        put(params, (f"conv_{name}", "bias"),
            sd[f"{hd}.conv_pred.conv_{name}.bias"].astype(np.float32))
    return {"params": params, "batch_stats": stats}


def convert_imvotenet(state_dict: dict):
    """Convert a reference ImVoteNet checkpoint to this framework's
    `ImVoteNet` trees: the 3D branch (pts_backbone), the img MLP and the
    JOINT tower head (reference keeps three separate tower heads,
    `imvotenet.py:94-100`; this framework shares one tower across
    joint/pts/img, so the joint head — the one test-time inference uses —
    is the one converted). The 2D branch is NOT convertible: this
    framework's `detector2d.py` is a deliberate FCOS-style redesign, not
    the reference's COCO Faster R-CNN (see its docstring).
    """

    def t2n(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    sd = {k: t2n(v) for k, v in state_dict.items()}
    out = convert_votenet(sd, head_prefix="pts_bbox_head_joint",
                          backbone_prefix="pts_backbone")
    params, stats = out["params"], out["batch_stats"]
    put = _mk_put(params, stats)
    i = 0
    while f"img_mlp.mlp.layer{i}.conv.weight" in sd:
        src = f"img_mlp.mlp.layer{i}"
        w = _dense_from_conv(sd[f"{src}.conv.weight"])
        put(params, (f"img_mlp{i}", "Dense_0", "kernel"), w)
        bias = sd.get(f"{src}.conv.bias")
        put(params, (f"img_mlp{i}", "Dense_0", "bias"),
            bias.astype(np.float32) if bias is not None
            else np.zeros(w.shape[1], np.float32))
        put(params, (f"img_mlp{i}", "BatchNorm_0", "scale"), sd[f"{src}.bn.weight"])
        put(params, (f"img_mlp{i}", "BatchNorm_0", "bias"), sd[f"{src}.bn.bias"])
        put(stats, (f"img_mlp{i}", "BatchNorm_0", "mean"),
            sd[f"{src}.bn.running_mean"])
        put(stats, (f"img_mlp{i}", "BatchNorm_0", "var"),
            sd[f"{src}.bn.running_var"])
        i += 1
    assert i > 0, "no img_mlp layers found (is this an ImVoteNet .pth?)"
    return {"params": params, "batch_stats": stats}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="fcaf3d",
                    choices=["fcaf3d", "votenet", "imvotenet"],
                    help="reference architecture in the .pth; with this, "
                    "all 5 north-star configs are convertible")
    ap.add_argument("--depth", type=int, default=34, choices=[14, 18, 34])
    ap.add_argument("--n-levels", type=int, default=4)
    ap.add_argument("--offset-order", default="x_fastest",
                    choices=["x_fastest", "x_slowest"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    # tensors and plain containers only: an mmcv checkpoint's "meta" holds
    # strings, numbers and tuples; anything else makes `torch.load` refuse
    # the file rather than run its pickled code
    ckpt = torch.load(args.pth, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    if args.model == "votenet":
        out = convert_votenet(sd)
    elif args.model == "imvotenet":
        out = convert_imvotenet(sd)
    else:
        layers = {14: (1, 1, 1, 1), 18: (2, 2, 2, 2),
                  34: (3, 4, 6, 3)}[args.depth]
        out = convert(sd, layers, args.n_levels, args.offset_order)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    n = len([None for _ in _iter_leaves(out["params"])])
    print(f"wrote {args.out} ({n} param tensors)")


def _iter_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _iter_leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
