"""Training STLT under a context of 2 at 512 layout frames (514 frame slots,
257 a rank) against the JAX package and the port's one process, on the CPU:
``tests/test_torch_ring_train_model.py``'s check, in a file of its own so
that each file's JAX compile stays within a minute. The temporal attention
runs the blockwise path (one process) and the ring's lengths mode (two
ranks), the tails the fused train tail's plain versions on both.
"""

from tests.test_torch_ring_train_model import check_context_2_train_steps


def test_context_2_train_steps_at_512_frames_match_jax_and_one_process(tmp_path, monkeypatch):
    check_context_2_train_steps(tmp_path, monkeypatch, 512)
