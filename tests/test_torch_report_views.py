"""Report/views tests: HTML export, ViewConfig semantics, views library
(``tests/test_report_views.py`` pointed at the port)."""

from repro_torch.core import NO_MATCH_MARKER, CallTree, ViewConfig, render_html, write_report
from repro_torch.core.report import EMPTY_VIEW_MARKER
from repro_torch.core.views_library import list_views, render_view


def sample_tree():
    t = CallTree()
    for _ in range(6):
        t.add_stack(["train_step", "model", "attention", "scores"], {"samples": 1, "flops": 100})
    for _ in range(3):
        t.add_stack(["train_step", "model", "mlp", "up_proj"], {"samples": 1, "flops": 300})
    t.add_stack(["train_step", "optimizer", "adamw"], {"samples": 1, "flops": 10})
    return t


class TestHtmlReport:
    def test_render_html_is_standalone(self):
        html = render_html(sample_tree(), title="t", metric="flops")
        assert html.startswith("<!DOCTYPE html>")
        assert "attention" in html and "calltree-json" in html
        # embedded JSON round-trips
        blob = html.split('id="calltree-json">')[1].split("</script>")[0]
        assert CallTree.from_json(blob).total("flops") == sample_tree().total("flops")

    def test_tag_shaped_names_are_escaped_not_swallowed(self):
        # Regression: a frame named "<module>" must land in the page as
        # visible text, not as a (vanishing) HTML tag.
        t = CallTree()
        t.add_stack(["<module>", "run"])
        page = render_html(t, title="t")
        assert "&lt;module&gt;" in page

    def test_script_closing_name_cannot_break_the_json_island(self):
        # Regression: the embedded JSON blob used to be interpolated raw, so
        # a frame named "</script>..." terminated the data island early and
        # spilled the rest of the tree into the page as markup.
        t = CallTree()
        t.add_stack(["<module>", "</script><script>alert(1)</script>", "leaf"])
        page = render_html(t, title="t")
        blob = page.split('id="calltree-json">')[1].split("</script>")[0]
        roundtripped = CallTree.from_json(blob)  # "<\/" decodes to "</"
        assert roundtripped.root == t.root
        body = page.split('id="calltree-json">')[0]
        assert "<script>alert(1)" not in body  # never as live markup

    def test_write_report_files(self, tmp_path):
        paths = write_report(sample_tree(), str(tmp_path), "r", metric="samples")
        assert (tmp_path / "r.html").exists() and (tmp_path / "r.json").exists()
        loaded = CallTree.from_json((tmp_path / "r.json").read_text())
        assert loaded.total() == 10


class TestViewConfig:
    def test_zoom_and_level(self):
        v = ViewConfig(name="attn", root="attention", level=1)
        t = v.apply(sample_tree())
        assert t.total() == 6
        assert "attention" in t.root.children
        assert not t.root.children["attention"].children  # folded at level 1

    def test_csv_shares_sum_leq_one_per_level(self):
        v = ViewConfig(name="x", level=1)
        csv = v.to_csv(sample_tree())
        rows = [l for l in csv.splitlines() if l and not l.startswith(("#", "path"))]
        shares = [float(r.rsplit(",", 1)[1]) for r in rows]
        assert all(0 <= s <= 1 for s in shares)
        assert abs(sum(shares) - 1.0) < 1e-6  # level-1 partitions the total

    def test_blacklist(self):
        v = ViewConfig(name="x", blacklist=["optimizer"])
        t = v.apply(sample_tree())
        assert t.total() == 10  # root metrics kept
        assert "optimizer" not in t.root.children["train_step"].children

    def test_no_match_root_emits_marker_not_vacuous_empty_csv(self):
        # Regression: root= matching nothing used to render a headers-only
        # CSV indistinguishable from "this component genuinely costs 0".
        v = ViewConfig(name="x", root="does_not_exist")
        csv = v.to_csv(sample_tree())
        assert f"{NO_MATCH_MARKER}does_not_exist" in csv
        assert not v.matches(sample_tree())
        assert ViewConfig(name="y", root="attention").matches(sample_tree())
        # a rootless view is never "no match"
        assert ViewConfig(name="z").matches(CallTree())

    def test_matched_root_with_empty_filters_is_not_reported_as_no_match(self):
        # root matched, but the whitelist removed every row: a *different*
        # marker — "no match for root=" here would point at the wrong knob.
        v = ViewConfig(name="x", root="attention", whitelist=["nonexistent_leaf"])
        csv = v.to_csv(sample_tree())
        assert NO_MATCH_MARKER not in csv
        assert EMPTY_VIEW_MARKER in csv
        assert v.matches(sample_tree())  # the root selector itself is fine

    def test_level_zero_fold_is_not_marked_empty(self):
        v = ViewConfig(name="x", root="attention", level=0)
        csv = v.to_csv(sample_tree())
        assert EMPTY_VIEW_MARKER not in csv and NO_MATCH_MARKER not in csv
        assert "total=6" in csv  # the fold keeps the total in the header

    def test_matching_whitelist_with_level_zero_is_not_marked_empty(self):
        # The filters matched; only the level fold emptied the children —
        # judging filters *after* the fold would falsely blame them.
        v = ViewConfig(name="x", root="attention", whitelist=["scores"], level=0)
        csv = v.to_csv(sample_tree())
        assert EMPTY_VIEW_MARKER not in csv and NO_MATCH_MARKER not in csv
        assert v.empty_marker(sample_tree()) is None


class TestViewsLibrary:
    def test_all_views_render_without_error(self):
        t = sample_tree()
        for name in list_views():
            csv = render_view(t, name)
            assert csv.startswith("# view=")

    def test_attention_view_isolates_component(self):
        csv = render_view(sample_tree(), "attention_internals")
        assert "scores" in csv and "mlp" not in csv

    def test_metric_override(self):
        csv = render_view(sample_tree(), "model_components", metric="flops")
        assert "metric=flops" in csv

    def test_library_covers_both_planes(self):
        names = list_views()
        assert any(n.startswith("host_") for n in names)
        assert any("collectives" in n for n in names)
        assert len(names) >= 20
