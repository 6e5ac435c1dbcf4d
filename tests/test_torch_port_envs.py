"""The port's env registry (``pydreamer_tpu_torch/envs``) against the JAX package's.

The envs are numpy code copied into the port, so the check is exact: the
same env id, worker id and wrapper options, stepped with the same actions,
give equal observation dicts (values and dtypes), rewards, dones and
``info["episode"]`` arrays. The scripted policies and the minigrid map
functions are held equal on the inputs ``tests/test_envs.py`` uses, and an
env id whose SDK is missing raises the same ``ImportError`` in both.
"""

import numpy as np
import pytest

import pydreamer_tpu.envs as jenvs
import pydreamer_tpu.envs.minigrid as jminigrid
import pydreamer_tpu.envs.miniworld as jminiworld
import pydreamer_tpu_torch.envs as tenvs
import pydreamer_tpu_torch.envs.minigrid as tminigrid
import pydreamer_tpu_torch.envs.miniworld as tminiworld


def _assert_same(got, want, what):
    """Exactly equal, nested through dicts, with equal dtypes for arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (what, got, want)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _actions(env, rng, n):
    """A fixed mix of int, one-hot and sampled actions (continuous: vectors)."""
    space = env.action_space
    out = []
    for i in range(n):
        if i % 3 == 2:
            out.append(None)  # each env draws from its own seeded space
        elif hasattr(space, "n"):
            a = int(rng.integers(space.n))
            out.append(a if i % 2 else np.eye(space.n)[a])
        else:
            out.append(rng.uniform(-1.5, 1.5, space.shape).astype(np.float32))
    return out


@pytest.mark.parametrize("no_terminal", [False, True])
@pytest.mark.parametrize("time_limit", [0, 7])
@pytest.mark.parametrize("worker_id", [0, 3])
@pytest.mark.parametrize("env_id", ["Grid-4x64", "Counting-10", "Bandit-3x8", "Point-2x32"])
def test_builtin_envs_step_alike(env_id, worker_id, time_limit, no_terminal):
    jenv = jenvs.create_env(env_id, no_terminal, time_limit, 1, worker_id)
    tenv = tenvs.create_env(env_id, no_terminal, time_limit, 1, worker_id)
    assert type(tenv.env).__name__ == type(jenv.env).__name__
    _assert_same(tenv.reset(), jenv.reset(), "reset")
    episodes = 0
    for i, a in enumerate(_actions(jenv, np.random.default_rng(worker_id), 80)):
        ja, ta = (jenv.action_space.sample(), tenv.action_space.sample()) if a is None else (a, a)
        _assert_same(ta, ja, f"sampled action {i}")
        tobs, trew, tdone, tinfo = tenv.step(ta)
        jobs, jrew, jdone, jinfo = jenv.step(ja)
        _assert_same(tobs, jobs, f"step {i} obs")
        assert (trew, tdone) == (jrew, jdone), i
        assert set(tinfo) == set(jinfo), i
        if jdone:
            episodes += 1
            _assert_same(tinfo["episode"], jinfo["episode"], f"step {i} episode")
            _assert_same(tenv.reset(), jenv.reset(), f"reset after step {i}")
    assert episodes >= 2


def _walls(n):
    m = np.full((n, n), 1)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = tminiworld.WALL
    return m


@pytest.mark.parametrize("case", ["corridor", "unreachable", "wide_turns"])
def test_find_shortest_matches(case):
    m = _walls(5)
    start, goal, turn = (1.5, 1.5, 0.0), (3.5, 3.5), 90.0
    if case == "unreachable":
        m = np.full((5, 5), 1)
        m[:, 2] = tminiworld.WALL
        goal = (1.5, 4.0)
    elif case == "wide_turns":
        m, goal, turn = _walls(7), (5.2, 1.7), 45.0
    got = tminiworld.find_shortest(m, start, goal, step_size=1.0, turn_size=turn)
    want = jminiworld.find_shortest(m, start, goal, step_size=1.0, turn_size=turn)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bouncing_ball_policy_matches():
    tp, jp = tminiworld.MazeBouncingBallPolicy(seed=0), jminiworld.MazeBouncingBallPolicy(seed=0)
    for pos in ([1.0, 1.0], [1.5, 1.0], [1.5, 1.0], [1.5, 1.0], [2.0, 1.0], [2.0, 1.0]):
        obs = dict(agent_pos=np.array(pos))
        _assert_same(tp(obs), jp(obs), f"pos {pos}")


def test_dijkstra_policy_matches():
    m = _walls(6)
    tp = tminiworld.MazeDijkstraPolicy(step_size=1.0, turn_size=90.0, random_prob=0.0, seed=0)
    jp = jminiworld.MazeDijkstraPolicy(step_size=1.0, turn_size=90.0, random_prob=0.0, seed=0)
    x, y, d = 1.5, 1.5, 0.0
    for i in range(12):
        obs = dict(agent_pos=np.array([x, y]), agent_dir=np.array([np.cos(d), np.sin(d)]),
                   map=m, map_agent=m, reset=i == 0)
        ta, ja = tp(obs)[0], jp(obs)[0]
        assert ta == ja, i
        if ja == 0:
            d -= np.pi / 2
        elif ja == 1:
            d += np.pi / 2
        else:
            x, y = x + np.cos(d), y + np.sin(d)


@pytest.mark.parametrize("agent_dir", [0, 1, 2, 3])
def test_minigrid_map_functions_match(agent_dir):
    W = H = 9
    for pos in ((5, 5), (0, 0)):
        _assert_same(tminigrid.view_to_global_coords(pos, agent_dir, 7, W, H),
                     jminigrid.view_to_global_coords(pos, agent_dir, 7, W, H), f"view {pos}")
    grid = np.ones((W, H), np.int64)
    grid[0, :] = grid[-1, :] = grid[:, 0] = grid[:, -1] = 2
    grid[7, 7] = 9
    for pos in ((4, 4), (0, 0)):
        _assert_same(tminigrid.centered_map(grid, pos, agent_dir, 2 * W - 3),
                     jminigrid.centered_map(grid, pos, agent_dir, 2 * W - 3), f"centered {pos}")
    vis = np.zeros((4, 4), bool)
    vis[1, 2] = True
    ages = []
    for mod in (tminigrid, jminigrid):
        age = np.full((4, 4), 500, np.uint16)
        mod.update_last_seen(age, vis, 500)
        mod.update_last_seen(age, np.zeros((4, 4), bool), 500)
        ages.append(age)
    _assert_same(*ages, "update_last_seen")
    obs_vis = np.random.default_rng(agent_dir).random((7, 7)) < 0.7
    got, want = (mod.map_observation(grid, (4, 4), agent_dir, obs_vis,
                                     np.full((W, H), 500, np.uint16), vis_cap=500,
                                     centered_size=2 * W - 3)
                 for mod in (tminigrid, jminigrid))
    _assert_same(got, want, "map_observation")


@pytest.mark.parametrize("env_id", ["Atari-Pong", "AtariGray-Breakout", "MiniGrid-Empty-5x5-v0",
                                    "MiniWorld-Hallway-v0", "DmLab-rooms_watermaze",
                                    "DMM-spot_diff_passive_train", "MineRLTreechop-v0",
                                    "Embodied-minecraft_diamond", "DMC-cartpole_balance",
                                    "CartPole-v1"])
def test_sdk_prefixes_dispatch_alike(env_id):
    """Each prefix reaches the same adapter: where its SDK is missing both
    raise the same ImportError; where it is installed both build the env and
    agree on the first observation's keys and shapes."""
    results = []
    for mod in (jenvs, tenvs):
        try:
            env = mod.create_env(env_id, False, 0, 1, 0)
        except ImportError as e:
            results.append((type(e), str(e)))
            continue
        obs = env.reset()
        results.append((type(env.env).__name__, {k: np.shape(v) for k, v in obs.items()}))
        env.close()
    assert results[1] == results[0]
