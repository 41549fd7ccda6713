"""Single-cell (10x Chromium) barcode handling.

Equivalent of src/single-cell.c: read 1 of a 10x pair is a 16-bp cell
barcode followed by a molecular barcode (UMI); barcodes are confirmed
against a whitelist, and near-miss barcodes are error-corrected by a
posterior over 1-edit whitelist neighbors weighted by dataset-frequency
priors and base quality (correct_barcode_error, src/single-cell.c:776-851,
CONFIDENCE_THRESHOLD 0.975). Alignments of read 2 carry the 10x SAM tags
CR/CY (raw barcode+quality), CB (confirmed/corrected barcode), UR/UY
(raw UMI+quality) (Single_cell_print_fields, src/single-cell.c:930-1023).
The port's copy of tpumap/gsnap/single_cell.py.
"""
from __future__ import annotations

from collections import Counter

CELL_BARCODE_LEN = 16          # src/single-cell.c:34
CONFIDENCE_THRESHOLD = 0.975   # src/single-cell.c:771
ILLUMINA_QUAL_OFFSET = 33


class SingleCell:
    def __init__(self, whitelist, barcode_len: int = CELL_BARCODE_LEN):
        self.barcode_len = barcode_len
        self.whitelist = set(whitelist)
        self.counts = Counter()
        self.total = 0

    @classmethod
    def from_file(cls, path: str) -> "SingleCell":
        from tpumap_torch.io.fasta import _open_text
        wl = []
        fh = _open_text(path)
        for line in fh:
            bc = line.strip().split("-")[0]
            if bc:
                wl.append(bc)
        return cls(wl, barcode_len=len(wl[0]) if wl else CELL_BARCODE_LEN)

    # pass 1 over the data: dataset barcode frequencies become the priors
    # (update_whitelist_counts, src/single-cell.c:343-431)
    def observe(self, read1_seq: str) -> None:
        bc = read1_seq[:self.barcode_len]
        if bc in self.whitelist:
            self.counts[bc] += 1
            self.total += 1

    def split_read1(self, seq: str, qual: str | None):
        """(barcode, bc_qual, umi, umi_qual)."""
        b = self.barcode_len
        q = qual or ""
        return seq[:b], q[:b], seq[b:], q[b:]

    def correct(self, barcode: str, qual: str) -> str | None:
        """Whitelist-confirmed or posterior-corrected barcode; None if
        unconfirmable (no CB tag is emitted then)."""
        if barcode in self.whitelist:
            return barcode
        if not self.total:
            return None
        best, best_lik, lik_sum = None, 0.0, 0.0
        bc = list(barcode)
        for pos in range(min(len(bc), self.barcode_len)):
            qv = (ord(qual[pos]) - ILLUMINA_QUAL_OFFSET) if pos < len(qual) \
                else 33
            p_edit = 10.0 ** (-min(qv, 33) / 10.0)
            orig = bc[pos]
            for base in "ACGT":
                if base == orig:
                    continue
                bc[pos] = base
                cand = "".join(bc)
                count = self.counts.get(cand, 0)
                if count > 0:
                    lik = (count / self.total) * p_edit
                    lik_sum += lik
                    if lik > best_lik:
                        best, best_lik = cand, lik
            bc[pos] = orig
        if best is not None and best_lik / lik_sum > CONFIDENCE_THRESHOLD:
            return best
        return None

    def sam_tags(self, read1_seq: str, read1_qual: str | None,
                 accession: str | None = None,
                 wellpos: int = 0) -> list[str]:
        bc, bq, umi, uq = self.split_read1(read1_seq, read1_qual)
        tags = [f"CR:Z:{bc}"]
        if bq:
            tags.append(f"CY:Z:{bq}")
        cb = self.correct(bc, bq)
        if cb is not None:
            # --10x-well-position: colon-separated accession field
            # appended to CB (src/gsnap.c wellpos, default 4)
            if wellpos > 0 and accession:
                fields = accession.split(":")
                if len(fields) >= wellpos:
                    cb = f"{cb}-{fields[wellpos - 1]}"
            tags.append(f"CB:Z:{cb}")
        tags.append(f"UR:Z:{umi}")
        if uq:
            tags.append(f"UY:Z:{uq}")
        return tags
