"""tpumap_torch-iit-store / -iit-get / -iit-dump (the port's copy of
tpumap/cli/iit_cli.py).

Mirror of the reference iit_store/iit_get/iit_dump CLIs
(src/iit_store.c:938, src/iit_get.c:971, src/iit_dump.c:188) over the
binary-compatible IIT implementation in tpumap_torch.io.iit; files written here
load in the reference tools and vice versa.
"""
from __future__ import annotations

import argparse
import sys

from tpumap_torch.cli._errors import clean_errors

from tpumap_torch.io.iit import (ALPHA_SORT, CHROM_SORT, NO_SORT,
                           NUMERIC_ALPHA_SORT, IIT, build_iit,
                           parse_map_fasta)

_SORTS = {"none": NO_SORT, "alpha": ALPHA_SORT,
          "numeric-alpha": NUMERIC_ALPHA_SORT, "chrom": CHROM_SORT}


def _outfile(name: str) -> str:
    return name if name.endswith(".iit") else name + ".iit"


@clean_errors
def store_main(argv=None):
    ap = argparse.ArgumentParser(prog="tpumap_torch-iit-store")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-1", "--oldformat", action="store_true",
                    help="write unified (version 1) format")
    ap.add_argument("-s", "--sort", default="chrom", choices=sorted(_SORTS))
    ap.add_argument("-G", "--gff", action="store_true",
                    help="parse input as GFF3 (label from ID/Name attribute)")
    ap.add_argument("-l", "--label", default="ID",
                    help="GFF3 attribute to use as the label")
    ap.add_argument("-v", "--iitversion", type=int, default=0)
    ap.add_argument("inputfile", nargs="?")
    args = ap.parse_args(argv)

    fh = open(args.inputfile) if args.inputfile else sys.stdin
    if args.gff:
        entries = parse_gff3(fh, label_attr=args.label)
    else:
        entries = parse_map_fasta(fh)
    if args.inputfile:
        fh.close()
    version = 1 if args.oldformat else args.iitversion
    iit = build_iit(entries, divsort=_SORTS[args.sort], version=version)
    iit.write(_outfile(args.output))
    return 0


def parse_gff3(fh, label_attr: str = "ID"):
    """GFF3 input for iit_store -G (src/iit_store.c parse_gff3)."""
    from tpumap_torch.io.iit import _Entry
    entries = []
    n = 0
    for line in fh:
        if line.startswith("#") or not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 9:
            continue
        seqid, _src, ftype, start, end, _score, strand, _phase, attrs = cols[:9]
        label = None
        for kv in attrs.split(";"):
            kv = kv.strip()
            if kv.startswith(label_attr + "="):
                label = kv[len(label_attr) + 1:]
                break
        if label is None:
            n += 1
            label = str(n)
        s, e = int(start), int(end)
        if strand == "-":
            s, e = e, s
        entries.append(_Entry(label=label, div=seqid, start=s, end=e,
                              typestr=ftype, restofheader="", annotation=""))
    return entries


@clean_errors
def get_main(argv=None):
    ap = argparse.ArgumentParser(prog="tpumap_torch-iit-get")
    ap.add_argument("-A", "--annotonly", action="store_true",
                    help="print annotation lines only")
    ap.add_argument("-S", "--sort", action="store_true",
                    help="sort results by coordinates")
    ap.add_argument("-L", "--label", action="store_true",
                    help="interpret the query as a label")
    ap.add_argument("-E", "--exact", action="store_true",
                    help="require exact coordinate match")
    ap.add_argument("iitfile")
    ap.add_argument("query", nargs="*",
                    help="label | coord | start end | div:start..end")
    args = ap.parse_args(argv)

    iit = IIT.read(_outfile(args.iitfile)
                   if not args.iitfile.endswith(".iit") else args.iitfile)
    out = sys.stdout

    matches = _resolve_query(iit, args.query, force_label=args.label,
                             exact=args.exact)
    if args.sort:
        matches = sorted(matches, key=lambda i: _pos_key(iit, i))
    for index in matches:
        if not args.annotonly:
            out.write(iit.header_line(int(index)) + "\n")
        out.write(iit.annotations[int(index) - 1])
    return 0


def _pos_key(iit: IIT, index: int):
    div, low, high, _sign, _t = iit.interval(int(index))
    return (iit.divs.index(div), low, high)


def _resolve_query(iit: IIT, query: list[str], force_label: bool = False,
                   exact: bool = False):
    if not query:
        return []
    if force_label:
        return list(iit.find(" ".join(query)))
    div = ""
    if len(query) == 1:
        q = query[0]
        if ":" in q:
            div, q = q.split(":", 1)
        if ".." in q:
            a, _, b = q.partition("..")
            try:
                x, y = int(a), int(b)
            except ValueError:
                return list(iit.find(query[0]))
        else:
            try:
                x = y = int(q)
            except ValueError:
                return list(iit.find(query[0]))
    elif len(query) == 2:
        try:
            x, y = int(query[0]), int(query[1])
        except ValueError:
            return list(iit.find(" ".join(query)))
    elif len(query) == 3:
        div = query[0]
        x, y = int(query[1]), int(query[2])
    else:
        return list(iit.find(" ".join(query)))
    if x > y:
        x, y = y, x
    hits = iit.get(div, x, y)
    if exact:
        hits = [i for i in hits
                if iit.interval(int(i))[1] == x and iit.interval(int(i))[2] == y]
    return list(hits)


@clean_errors
def dump_main(argv=None):
    ap = argparse.ArgumentParser(prog="tpumap_torch-iit-dump")
    ap.add_argument("-S", "--sort", action="store_true",
                    help="sort entries by coordinates")
    ap.add_argument("-A", "--annotonly", action="store_true")
    ap.add_argument("-L", "--labels", action="store_true",
                    help="print labels only, one per line")
    ap.add_argument("iitfile")
    args = ap.parse_args(argv)
    iit = IIT.read(args.iitfile)
    out = sys.stdout
    if args.labels:
        for lab in iit.labels:
            out.write(lab + "\n")
        return 0
    indices = range(1, iit.total_nintervals + 1)
    if args.sort:
        indices = sorted(indices, key=lambda i: _pos_key(iit, i))
    for index in indices:
        if not args.annotonly:
            out.write(iit.header_line(int(index)) + "\n")
        out.write(iit.annotations[int(index) - 1])
    return 0


if __name__ == "__main__":
    prog = sys.argv[1] if len(sys.argv) > 1 else "dump"
    {"store": store_main, "get": get_main,
     "dump": dump_main}[prog](sys.argv[2:])
