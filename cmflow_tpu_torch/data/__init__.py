"""Sample schema, VoD sample decoding and the synthetic scene generator
(copies of the JAX-free host modules of ``cmflow_tpu/data``)."""
