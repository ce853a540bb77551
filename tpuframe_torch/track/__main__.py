"""``python -m tpuframe_torch.track``: the observability CLI.

Subcommands:

    analyze <dir> [--trace out.json] [--report] [--baseline results/]
        Merge a TPUFRAME_TELEMETRY_DIR of per-rank events-rank*.jsonl
        logs into a Perfetto-loadable trace and a cross-rank skew
        report (tpuframe_torch.track.analyze).

Port of ``tpuframe/track/__main__.py``: reading a wedged fleet's logs
needs no card.
"""

import sys


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "analyze":
        from tpuframe_torch.track.analyze import main as analyze_main

        return analyze_main(argv[1:])
    prog = "python -m tpuframe_torch.track"
    if argv and argv[0] not in ("-h", "--help"):
        print(f"{prog}: unknown command {argv[0]!r}", file=sys.stderr)
    print(
        f"usage: {prog} analyze <telemetry-dir> "
        "[--trace out.json] [--report] [--baseline results/] [--json]",
        file=sys.stderr,
    )
    return 0 if argv and argv[0] in ("-h", "--help") else 2


if __name__ == "__main__":
    raise SystemExit(main())
