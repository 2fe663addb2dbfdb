"""DBoW2 vocabulary-file validation (the --vocabulary_file CLI contract).

The reference loads ORBvoc.txt via DBoW2 TemplatedVocabulary and fails on a
bad path/file (System.cc). This framework validates the file but replaces
the index with exhaustive Hamming matching; these tests pin the validator's
accept/reject behavior on the DBoW2 text format.
"""

import pytest

from pilotguru.vo.vocabulary import validate_dbow2_vocabulary


def _node_line(parent=0, is_leaf=1, weight=1.5, byte=7):
    descriptor = " ".join(str(byte) for _ in range(32))
    return f"{parent} {is_leaf} {descriptor} {weight}\n"


def _write(tmp_path, text):
    path = tmp_path / "voc.txt"
    path.write_text(text)
    return str(path)


class TestValidateVocabulary:
    def test_accepts_wellformed_file(self, tmp_path):
        path = _write(
            tmp_path, "10 6 0 0\n" + _node_line() + _node_line(parent=1)
        )
        info = validate_dbow2_vocabulary(path)
        assert info.branching_factor == 10
        assert info.depth_levels == 6
        assert info.num_nodes == 2

    def test_max_nodes_bounds_validation_but_counts_all(self, tmp_path):
        lines = [_node_line() for _ in range(5)]
        # Nodes past max_nodes are counted without field checks: corrupt the
        # LAST line — it must not be reached.
        lines.append("garbage line\n")
        path = _write(tmp_path, "10 6 0 0\n" + "".join(lines))
        info = validate_dbow2_vocabulary(path, max_nodes=5)
        assert info.num_nodes == 6

    @pytest.mark.parametrize(
        "text, match",
        [
            ("", "header"),
            ("10 6\n", "header"),
            ("a b c d\n", "non-integer"),
            ("1 0 0 0\n" + "0 1 " + "0 " * 32 + "1.0\n", "implausible"),
            ("10 6 9 0\n" + "0 1 " + "0 " * 32 + "1.0\n", "scoring"),
            ("10 6 0 0\n", "no nodes"),
            ("10 6 0 0\n0 1 2 3\n", "fields"),
            ("10 6 0 0\n0 1 " + "0 " * 31 + "999 1.0\n", "255"),
            ("10 6 0 0\n0 7 " + "0 " * 32 + "1.0\n", "out of range"),
        ],
    )
    def test_rejects_malformed(self, tmp_path, text, match):
        path = _write(tmp_path, text)
        with pytest.raises(ValueError, match=match):
            validate_dbow2_vocabulary(path)

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(OSError):
            validate_dbow2_vocabulary(str(tmp_path / "absent.txt"))

    def test_cli_validates_when_flag_given(self, tmp_path, capsys):
        # The CLI must fail loudly on an invalid vocabulary BEFORE any
        # tracking work (reference: System constructor aborts on a bad
        # vocabulary load).
        from pilotguru.cli import optical_trajectories

        bad = _write(tmp_path, "not a vocabulary\n")
        with pytest.raises(ValueError, match="header"):
            optical_trajectories.main(
                [
                    f"--vocabulary_file={bad}",
                    "--camera_settings=/nonexistent.yaml",
                    "--in_video=/nonexistent.mp4",
                    f"--out_dir={tmp_path}",
                ]
            )
