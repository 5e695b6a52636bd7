import io

import numpy as np

from slam3d_gx.geometry import se3
from slam3d_gx.io import g2o_io


def make_graph(rng):
    g = g2o_io.Graph()
    from scipy.spatial.transform import Rotation

    for i in range(5):
        R = Rotation.random(random_state=np.random.RandomState(i)).as_matrix()
        g.add_vertex(i, se3.make_isometry(R, rng.normal(size=3)), fixed=(i == 0))
    info = np.diag([100.0, 100, 100, 100, 100, 100])
    for i in range(4):
        R = Rotation.random(random_state=np.random.RandomState(100 + i)).as_matrix()
        g.add_edge(i, i + 1, se3.make_isometry(R, rng.normal(size=3)), info)
    # a loop edge with a non-diagonal information matrix
    A = rng.normal(size=(6, 6))
    g.add_edge(0, 4, np.eye(4), A @ A.T + 6 * np.eye(6), robust=True)
    return g


def test_roundtrip(rng):
    g = make_graph(rng)
    buf = io.StringIO()
    g2o_io.write_g2o(g, buf)
    buf.seek(0)
    g2 = g2o_io.read_g2o(buf)
    assert set(g2.vertices) == set(g.vertices)
    assert g2.vertices[0].fixed and not g2.vertices[1].fixed
    for vid in g.vertices:
        np.testing.assert_allclose(g2.vertices[vid].T, g.vertices[vid].T, atol=1e-8)
    assert len(g2.edges) == len(g.edges)
    for e1, e2 in zip(g.edges, g2.edges):
        assert (e1.id1, e1.id2) == (e2.id1, e2.id2)
        np.testing.assert_allclose(e1.T, e2.T, atol=1e-8)
        np.testing.assert_allclose(e1.information, e2.information, rtol=1e-8)


def test_line_format(rng):
    g = g2o_io.Graph()
    g.add_vertex(0, np.eye(4), fixed=True)
    g.add_vertex(1, se3.make_isometry(np.eye(3), [1, 2, 3]))
    g.add_edge(0, 1, se3.make_isometry(np.eye(3), [1, 2, 3]), np.eye(6) * 100)
    buf = io.StringIO()
    g2o_io.write_g2o(g, buf)
    lines = buf.getvalue().strip().split("\n")
    assert lines[0] == "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1"
    assert lines[1] == "FIX 0"
    assert lines[2] == "VERTEX_SE3:QUAT 1 1 2 3 0 0 0 1"
    edge = lines[3].split()
    assert edge[0] == "EDGE_SE3:QUAT"
    assert edge[1:3] == ["0", "1"]
    assert len(edge) == 3 + 7 + 21  # tag(1)+ids(2) handled, pose 7, info 21
    # upper-triangular diag(100): entries 0, 6, 11, 15, 18, 20 are 100
    info_vals = [float(x) for x in edge[10:31]]
    diag_pos = [0, 6, 11, 15, 18, 20]
    for i, v in enumerate(info_vals):
        assert v == (100.0 if i in diag_pos else 0.0)


def test_ignores_comments_and_unknown_tags():
    text = """# comment
VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1
PARAMS_SE3OFFSET 0 0 0 0 0 0 0 1
VERTEX_SE3:QUAT 1 1 0 0 0 0 0 1
EDGE_SE3:QUAT 0 1 1 0 0 0 0 0 1 100 0 0 0 0 0 100 0 0 0 0 100 0 0 0 100 0 0 100 0 100
"""
    g = g2o_io.read_g2o(io.StringIO(text))
    assert len(g.vertices) == 2 and len(g.edges) == 1
    np.testing.assert_allclose(g.edges[0].information, np.eye(6) * 100)
