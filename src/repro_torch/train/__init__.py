"""Training, ported from the JAX package's `train/`: the optimizers
(`optimizers`), error-feedback gradient compression (`compression`), the
train and serving steps (`steps`) and the host loop with checkpoints and
resume (`trainer`). The train steps refuse a mesh context until ROADMAP
A16's dry-run."""
