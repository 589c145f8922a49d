"""The distributed layer of the port: one process per device, joined by a
torch.distributed process group (NCCL on CUDA, gloo on the CPU).

  mesh             the 1-D data mesh, mesh_2d, the counted collectives
  multihost        the process group from the environment, sharded reading
  dist_gp          the row-sharded objectives (FTC, DTC, DTCVAR, FITC)
  chol_distributed the panel Cholesky and the fused distributed evidence
  dist_ftc         FTC with K row-sharded: objective and posterior
  dist_gplvm       the GP-LVM / GPDM with the latent rows sharded
  dist_iterative   the matrix-free evidence with the MVM row-sharded
  dist_ivm         the IVM's selection with the data rows sharded
  dist_sparse2d    DTC / DTCVAR / FITC on the (mp, dp) mesh
  scaling_bench    weak scaling and the collective census
"""
