"""The rank launcher of the port's multi-process tests
(tests/torch_ranks.py): a launch whose rank finds its port taken
(EADDRINUSE) starts again on a new port; any other failure comes back as
it came, with no relaunch."""

import socket

from tests import torch_ranks as R

# Rank 0 (argv[2]) binds the port of argv[1] ("host:port") as a store
# would; on failure it names EADDRINUSE as c10d's store does and exits
# 1. Every rank prints the port it was given.
BIND = """
import socket, sys
host, port = sys.argv[1].rsplit(":", 1)
if sys.argv[2] == "0":
    s = socket.socket()
    try:
        s.bind((host, int(port)))
    except OSError:
        sys.stderr.write("name: EADDRINUSE, message: address already in use")
        sys.exit(1)
print(port)
"""


def test_a_taken_port_relaunches_the_ranks_on_a_new_one():
    taken = R.free_port()
    with socket.socket() as held:
        held.bind(("127.0.0.1", taken))
        results = R.launch(
            [["-c", BIND, f"127.0.0.1:{taken}", str(r)] for r in (0, 1)],
            [{"COORD": f"127.0.0.1:{taken}"}] * 2, timeout=60)
    assert [rc for rc, *_ in results] == [0, 0], results
    ports = {so.strip() for _, so, _, _ in results}
    assert len(ports) == 1 and str(taken) not in ports


def test_other_failures_come_back_without_a_relaunch():
    argv = ["-c", "import sys; sys.stderr.write('boom'); sys.exit(3)",
            "127.0.0.1:1"]
    results = R.launch([argv], [{}], timeout=60)
    assert results[0][0] == 3 and results[0][2] == "boom"
    # Out of relaunches, the EADDRINUSE failure itself is returned.
    taken = R.free_port()
    with socket.socket() as held:
        held.bind(("127.0.0.1", taken))
        results = R.wait(R.start([["-c", BIND, f"127.0.0.1:{taken}", "0"]],
                                 [{}]), timeout=60, relaunches=0)
    assert results[0][0] == 1 and "EADDRINUSE" in results[0][2]


def test_only_a_port_free_port_handed_out_is_the_launch_port():
    port = R.free_port()
    argvs = [["cuda:0", "x:1", f"127.0.0.1:{port}"]]
    assert R._port_in(argvs, [{"DEV": "cuda:0"}]) == str(port)
    assert R._port_in([["cuda:0"]], [{"DEV": "x:1"}]) is None
