"""An autouse fixture for the port's heaviest CPU test files: every test on
one intra-op thread, the thread count put back after. Import it into a
test module (`from torch_threads import one_intra_op_thread`) to apply it
there.

The suite runs on six xdist workers, and torch's default pool (a thread a
core in every worker) oversubscribes the cores. On an 8-core CPU, in the
full suite: `sac_humanoid`'s one bf16 host iteration took 428 s (25 s
alone on eight threads, 5 s alone on one); IMPALA's two-state-MDP
learning check 427 s (12 s and 8 s alone); PPO's two-state learning check
200 s; the entry-point check's CPU `ppo_cartpole` iteration 134 s (24 s
alone).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
