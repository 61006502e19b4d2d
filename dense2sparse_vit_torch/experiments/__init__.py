"""Small experiments of the port (counterparts of `dense2sparse_vit_tpu/experiments`)."""
