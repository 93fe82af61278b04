"""The port's own copy of the genome reference lookup it calls from
wgbs_tools_tpu/genome/: reference directories, the CpG index and region
parsing (same names, no jax in either)."""
