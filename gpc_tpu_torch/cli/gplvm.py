"""`gplvm` command-line tool on PyTorch (counterpart of gpc_tpu/cli/gplvm.py,
the reference's gplvm.cpp): GP-LVM and GPDM.

Commands: learn / display / gnuplot, with gpc_tpu's flags, defaults,
messages, model-file comment and output files:

    python -m gpc_tpu_torch.cli.gplvm [-v verbosity] [-s seed] [--device cpu|cuda] COMMAND ...

learn takes -x latent dimension, -k/-g/-v/-w/-b/-d/-i the latent kernel,
-c a back-constraint kernel (its Gram over Y), -D a dynamics kernel with
-dr the signal-to-noise ratio (fixed-SNR dynamics by default, -dr -1 to
learn them) and -ds the scale, -C centre, -S scale, -L learn scales,
-R regularise the latents, -I pca|rand, -O scg|conjgrad|graddesc|quasinew,
-# iterations, and --checkpoint file [--checkpoint-every N] [--resume].
-f 1 exits "not yet ported".  Every command runs on the card unless
`--device cpu` is given; GPC_TPU_EVIDENCE=dense|lazy|panel|iterative
selects the evidence engine of training, as in gpc_tpu.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpc_tpu_torch import NoDeviceError, as_tensor, resolve_device
from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch.cli.common import CommandLine, ExitError, KernelSpecParser, load_data
from gpc_tpu_torch.io import model_io
from gpc_tpu_torch.models.gplvm import GPLVM


def _help():
    print("GPLVM tool (gpc_tpu_torch).\n"
          "Commands: learn display gnuplot\n"
          "Global options: -v verbosity -s seed --device cpu|cuda (default cuda)\n"
          "Learn options: -x latent-dim (2) -c back-kernel -D dynamics-kernel\n"
          "  -dr dynamics-SNR -ds dynamics-scale -C centre (1) -S scale (0)\n"
          "  -L learn-scales -R regularise-latent (1) -I pca|rand\n"
          "  -k kernel specs (-g/-v/-w/-b/-d/-i)  -O optimiser  -# iters\n"
          "  --checkpoint file [--checkpoint-every N] [--resume]  preemption checkpoints\n"
          "Not yet ported: -f 1.")


def _dynamics(ks: KernelSpecParser, q: int, ratio: float, scale: float):
    """(dynamics kernel, its params, learnt): the -D leaves plus bias,
    rescaled to variance scale² (setVariance, gplvm.cpp:498), plus white at
    scale/ratio² (gpc_tpu's rule, kept) and frozen unless ratio is −1
    (gplvm.cpp:499-500, 547)."""
    dk, dp = ks.build(q, usage="dyn", default_type=None, add_bias_white=False)
    bias = KM.Bias(input_dim=q)
    dyn_kern = KM.Cmpnd(input_dim=q, components=tuple(dk.components) + (bias,))
    dp = np.concatenate([dp, bias.default_params()])
    dp = dyn_kern.set_variance(torch.as_tensor(dp), scale ** 2).numpy()
    white = KM.White(input_dim=q)
    wp = white.default_params()
    learnt = True
    if ratio != -1.0:
        wp[0] = scale / (ratio ** 2)
        learnt = False
    dyn_kern = KM.Cmpnd(input_dim=q, components=dyn_kern.components + (white,))
    return dyn_kern, np.concatenate([dp, wp]), learnt


def learn(cl: CommandLine):
    cl.advance()
    ks = KernelSpecParser()
    latent_dim = 2
    centre, scale_data = True, False
    learn_scales, regularise = False, True
    init_type = "pca"
    optimiser = "scg"
    dynamics_used = False
    # fixed-SNR dynamics at ratio 20 by default (gplvm.cpp:115, 499-500, 547)
    dynamics_ratio = 20.0
    dynamics_scale = 0.5
    iters = 1000
    model_file = "gplvm_model"
    ckpt_path, ckpt_every, resume = None, 50, False
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-?", "-h", "--help"):
            _help()
            return
        elif arg == "--checkpoint":
            # long form only: -c is the back-constraint kernel here
            ckpt_path = cl.get_string()
            cl.advance()
        elif arg == "--checkpoint-every":
            ckpt_every = cl.get_int()
            cl.advance()
        elif arg == "--resume":
            resume = True
            cl.advance()
        elif arg in ("-x", "--latent-dim"):
            latent_dim = cl.get_int()
            cl.advance()
        elif arg in ("-c", "--constrained"):
            ks.add_type(cl.get_string(), usage="back")
            cl.advance()
        elif arg in ("-D", "--dynamics-kernel"):
            dynamics_used = True
            ks.add_type(cl.get_string(), usage="dyn")
            cl.advance()
        elif arg in ("-dr", "--dynamics-ratio"):
            if not dynamics_used:
                raise ExitError("You need to declare a dynamics kernel before setting the "
                                "dynamics signal to noise ratio. Default is 10.")
            dynamics_ratio = cl.get_double()
            cl.advance()
        elif arg in ("-ds", "--dynamics-scale"):
            if not dynamics_used:
                raise ExitError("You need to declare a dynamics kernel before setting the "
                                "dynamics scale.")
            dynamics_scale = cl.get_double()
            cl.advance()
        elif arg in ("-C", "--Centre-data"):
            centre = cl.get_bool()
            cl.advance()
        elif arg in ("-I", "--Initialise"):
            init_type = cl.get_string()
            cl.advance()
        elif arg in ("-L", "--Learn-scales"):
            learn_scales = cl.get_bool()
            cl.advance()
        elif arg in ("-R", "--Regularise"):
            regularise = cl.get_bool()
            cl.advance()
        elif arg in ("-S", "--Scale-data"):
            scale_data = cl.get_bool()
            cl.advance()
        elif arg in ("-O", "--optimiser"):
            optimiser = cl.get_string()
            cl.advance()
            if optimiser not in ("scg", "conjgrad", "graddesc", "quasinew"):
                raise ExitError("Unrecognised model optimiser type.")
        elif arg in ("-#", "--#iterations"):
            iters = cl.get_int()
            cl.advance()
        elif arg in ("-f", "--file-format"):
            cl.file_format = cl.get_int()
            cl.advance()
        elif ks.handle(cl):
            pass
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    if init_type not in ("pca", "rand"):
        raise ExitError(f"Unknown initialisation type: {init_type}")
    data_file = cl.current()
    if cl.pos + 1 < len(cl.argv):
        model_file = cl.argv[cl.pos + 1]

    Y, ylab = load_data(data_file, cl.file_format)
    # integer svml labels are kept for plotting only (gplvm.cpp:342-358)
    labels = ylab[:, 0].astype(int) if np.all(ylab == np.round(ylab)) else None
    q = latent_dim
    dev = resolve_device(cl.device)

    kern, kern_params = ks.build(q, usage="fwd", default_type="rbf")
    dyn_kern, dyn_params, dyn_learnt = None, None, True
    if "dyn" in ks.usage:
        dyn_kern, dyn_params, dyn_learnt = _dynamics(ks, q, dynamics_ratio, dynamics_scale)
    # the back-constraint kernel's Gram over Y (gplvm.cpp:527-537)
    bK = None
    if "back" in ks.usage:
        bkern, bparams = ks.build(Y.shape[1], usage="back", default_type=None,
                                  add_bias_white=False)
        with torch.no_grad():
            bK = bkern.gram(as_tensor(bparams, dev), as_tensor(Y, dev)).cpu().numpy()
        bK = bK.astype(np.float64)

    model = GPLVM(kern, Y, latent_dim=q, dyn_kern=dyn_kern,
                  dyn_kern_params=dyn_params, dyn_kern_learnt=dyn_learnt,
                  back_kernel_matrix=bK, centre=centre, scale_data=scale_data,
                  learn_scales=learn_scales, latent_regularised=regularise,
                  init=init_type, seed=cl.seed, device=dev)
    # the kernel parameters the command line set
    Xvals = (model.spec.unpack(torch.as_tensor(model.theta))[2].numpy()
             if model.spec.back_constrained else model.latent_X())
    model.theta = model.spec.pack(
        kern_params, Xvals,
        dyn_params=dyn_params if (dyn_kern is not None and dyn_learnt) else None,
        scales=model.fixed_scales if learn_scales else None)
    res = model.optimise(iters=iters, optimiser=optimiser, verbose=cl.verbosity,
                         ckpt_path=ckpt_path, ckpt_every=ckpt_every, resume=resume)
    if cl.verbosity > 0:
        print(model.display())
        print(f"Final objective: {float(res.obj)} after {int(res.iters)} iterations")
    comment = "Run as: " + " ".join(sys.argv) + f" with seed {cl.seed}."
    model_io.write_gplvm(model_file, model, labels=labels, comment=comment)


def display(cl: CommandLine):
    cl.advance()
    model_file = cl.current() if cl.has_more() else "gplvm_model"
    model, _ = model_io.read_gplvm(model_file, device=cl.device)
    print(model.display())


def _write_points(fn, X):
    with open(fn, "w") as f:
        for row in X:
            f.write(f"{row[0]:.17e} {row[1]:.17e} 0.1\n")


def gnuplot(cl: CommandLine):
    """The latent scatter per label and the log-precision grid of the
    posterior variance (gplvm.cpp:648-830)."""
    cl.advance()
    point_size, resolution = 2.0, 80
    label_file = None
    model_file, name = "gplvm_model", "gplvm"
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-l", "--labels"):
            label_file = cl.get_string()
            cl.advance()
        elif arg in ("-p", "--point-size"):
            point_size = cl.get_double()
            cl.advance()
        elif arg in ("-r", "--resolution"):
            resolution = cl.get_int()
            cl.advance()
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    if cl.has_more():
        model_file = cl.current()
    if cl.pos + 1 < len(cl.argv):
        name = cl.argv[cl.pos + 1]
    model, labels = model_io.read_gplvm(model_file, device=cl.device)
    if model.spec.latent_dim != 2:
        raise ExitError("Plotting is only implemented for 2 dimensional latent spaces.")
    if label_file:
        with open(label_file) as f:
            labels = np.array([int(ln) for ln in f if ln.strip()])
        if len(labels) != model.spec.n_data:
            raise ExitError("Incorrect number of labels")

    X = model.latent_X()
    data_files = []
    if labels is not None:
        for lab in np.unique(labels):
            fn = f"{name}_latent_data{int(lab)}.dat"
            _write_points(fn, X[labels == lab])
            data_files.append(fn)
    else:
        fn = f"{name}_latent_data.dat"
        _write_points(fn, X)
        data_files.append(fn)

    mins, maxs = X.min(0), X.max(0)
    span = maxs - mins
    xs = np.linspace(mins[0] - 0.05 * span[0], maxs[0] + 0.05 * span[0], resolution)
    ys = np.linspace(mins[1] - 0.05 * span[1], maxs[1] + 0.05 * span[1], resolution)
    XX, YY = np.meshgrid(xs, ys)
    _, var = model.predict_from_latent(np.column_stack([XX.ravel(), YY.ravel()]))
    logprec = -np.log(var[:, 0]).reshape(resolution, resolution)
    with open(f"{name}_variance_matrix.dat", "w") as f:
        f.write("# Prepared plot of model file \n")
        for i in range(resolution):
            for j in range(resolution):
                f.write(f"{xs[j]:.17e} {ys[i]:.17e} {logprec[i, j]:.17e}\n")
            f.write("\n")
    with open(f"{name}_plot.gp", "w") as f:
        f.write("set pm3d map\n")
        f.write(f'splot "{name}_variance_matrix.dat"')
        for fn in data_files:
            f.write(f', "{fn}" with points ps {point_size}')
        f.write("\npause -1\n")


COMMANDS = {"learn": learn, "display": display, "gnuplot": gnuplot}


def main(argv=None):
    cl = CommandLine(argv if argv is not None else sys.argv[1:])
    cl.eat_global_flags()
    if not cl.has_more():
        _help()
        raise ExitError("No command provided.")
    np.random.seed(cl.seed % (2 ** 32))
    cmd = cl.current()
    if cmd not in COMMANDS:
        _help()
        raise ExitError(f"Invalid gplvm command provided: {cmd}")
    try:
        COMMANDS[cmd](cl)
    except FileNotFoundError as e:
        raise ExitError(f"Unable to read file {e.filename}.")
    except (ValueError, NotImplementedError, NoDeviceError) as e:
        raise ExitError(str(e))


if __name__ == "__main__":
    main()
