"""ray_tpu_torch.rllib — RL training: env-runner actors + a torch learner.

Port of ``ray_tpu/rllib/__init__.py`` (analog of the reference RLlib core
loop, rllib/algorithms/algorithm.py + core/learner/learner_group.py +
EnvRunnerGroup): parallel env-runner actors collect rollouts under the
current policy on the CPU; the learner applies GAE + the PPO clipped
surrogate (or DQN's TD step, or IMPALA's V-trace update) with Adam on
its device, the card unless the config names another.
"""
from .cartpole import CartPoleEnv  # noqa: F401
from .dqn import DQN, DQNConfig  # noqa: F401
from .impala import IMPALA, ImpalaConfig  # noqa: F401
from .ppo import PPO, PPOConfig  # noqa: F401
from .replay import ReplayBuffer  # noqa: F401
