"""The port's artifact store and checkpoints, copies of
``tpu2048/store`` in the reference's format; weights come out as
torch tensors."""
