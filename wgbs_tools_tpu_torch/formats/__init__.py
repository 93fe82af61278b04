"""The port's own copy of the pat / beta / BGZF / blocks bed / .tbi host
code it calls from wgbs_tools_tpu/formats/ (same names, no jax in either)."""
