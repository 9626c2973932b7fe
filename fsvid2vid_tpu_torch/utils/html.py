"""Static HTML result galleries (the port's copy of fsvid2vid_tpu/utils/html.py;
reference util/html.py, dominate-free)."""
from __future__ import annotations

import html
import os
from typing import List


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self.body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self.body.append(f"<h3>{html.escape(str(text))}</h3>")

    def add_images(self, ims: List[str], txts: List[str], links: List[str],
                   width: int = 512) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td style='text-align:center;vertical-align:top'>"
                f"<a href='images/{link}'>"
                f"<img style='width:{width}px' src='images/{im}'></a><br>"
                f"<p>{html.escape(str(txt))}</p></td>")
        self.body.append("<table border='1' style='border-collapse:collapse'>"
                         "<tr>" + "".join(cells) + "</tr></table>")

    def save(self) -> str:
        meta = (f"<meta http-equiv='refresh' content='{self.refresh}'>"
                if self.refresh else "")
        doc = ("<!DOCTYPE html><html><head>"
               f"<title>{html.escape(self.title)}</title>{meta}</head><body>"
               + "\n".join(self.body) + "</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write(doc)
        return path
